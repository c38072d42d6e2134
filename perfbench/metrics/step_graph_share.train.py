"""step_graph_share.train: the share of the traced steps that replayed a
CUDA graph of the step, in %: of the port's `ftt.train.step` spans of the
traced steps (read from its span store, `utils/profiling.py:spans`,
through perfbench/harness/spans.py), those whose `path` is 'replay'
(`train/common.py:StepGraphs`). None where the steps carry no `path` (a
program without the step graphs) or there is nothing to read. Layer:
train/common.py:train_step."""
from perfbench.harness.spans import traced_spans


def read(ctx):
    got = traced_spans(ctx)
    if got is None:
        return None
    from forwardtacotron_tpu_torch.utils.profiling import STEP_SPAN
    steps = [s for s in got[0] if s.name == STEP_SPAN]
    if not all('path' in s.attrs for s in steps):
        return None
    return 100.0 * sum(s.attrs['path'] == 'replay' for s in steps) \
        / len(steps)
