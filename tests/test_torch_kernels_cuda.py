"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip elsewhere.
Run them on a CUDA machine with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerances: float32 at atol 1e-4 (summation order differs); bfloat16
at atol 2e-2 (a bf16 rounding flip of h moves a step by one bf16 ulp);
greedy sampling trajectories agree on > 95% of samples.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (kernels are built with nvcc)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.parametrize('cell,H,S,B', [('lstm', 256, 2, 3),
                                        ('gru', 128, 6, 1),
                                        ('gru', 96, 2, 2)])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_birnn_kernel_matches_plain(cuda, cell, H, S, B, dtype, tol):
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.ops.rnn import birnn_recurrence
    g = torch.Generator().manual_seed(H + S)
    T, ng = 70, (4 if cell == 'lstm' else 3)
    gi = (torch.randn((T, B, S, ng * H), generator=g) * 0.5).to(dtype)
    w = ((torch.rand((S, ng * H, H), generator=g) * 2 - 1)
         / H ** 0.5).to(dtype)
    b = torch.zeros((S, ng * H)) if cell == 'lstm' else \
        torch.rand((S, ng * H), generator=g) * 0.1
    lengths = torch.tensor([T - 9 * i for i in range(B)], dtype=torch.int32)
    args = [t.to(cuda).contiguous() for t in (gi, w, b, lengths)]
    before = recurrence.launches
    y = recurrence(cell, *args, dtype)
    assert recurrence.launches == before + 1
    ref = birnn_recurrence(cell, *args, dtype)
    assert float((y - ref).abs().max()) <= tol


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_sampler_kernel_matches_plain(cuda, mode):
    from forwardtacotron_tpu_torch.kernels import wavernn_sample as ws
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    torch.manual_seed(0)
    model = WaveRNN(rnn_dims=128, fc_dims=128, feat_dims=20, res_blocks=1,
                    compute_dims=16, res_out_dims=16, mode=mode).to(cuda)
    f32 = torch.float32
    w = ws.pack_weights(model, f32)
    cond = (torch.randn((300, 12, 20 + 16), device=cuda) * 0.5).to(f32)
    nr_mix = 10 if mode == 'MOL' else 0
    k = ws.sample(cond, w, 0, nr_mix, True, f32)
    p = ws.sample_plain(cond, w, 0, nr_mix, True, f32)
    tol = 1e-6 if mode == 'RAW' else 1e-3
    assert float(((k - p).abs() < tol).float().mean()) > 0.95
    s1 = ws.sample(cond, w, 5, nr_mix, False, f32)
    s2 = ws.sample(cond, w, 5, nr_mix, False, f32)
    assert torch.equal(s1, s2) and bool((s1.abs() <= 1).all())
