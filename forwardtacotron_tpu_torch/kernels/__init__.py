"""The port's CUDA kernels and their wrappers. Importing the package
registers kernels #1 and #4 as the custom ops `ftt::birnn_recurrence` and
`ftt::wavernn_sample` (`kernels/ops.py`), which an exported program
needs when it is loaded; nothing is built until a kernel is launched."""
from forwardtacotron_tpu_torch.kernels import ops  # noqa: F401
