"""On the card, at the cell's own size: the control (the reference in
bfloat16 in the program's place) fails ForwardTacotron's training check,
and a sound run of the program passes it."""
import pytest
import torch

from perfbench.harness.train_steps import TrainCell
from perfbench.run import cell_inputs


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    _, _, cfg, traffic, workload = cell_inputs('ftw_ljspeech.train_b32')
    run = TrainCell(cfg, traffic, 2 ** 31 + 77)
    try:
        run.setup()
        run.release()
        ref = run.reference_run()
        program = run.compare(run.program, ref)
        control = run.compare(run.reference_run(dt=torch.bfloat16), ref)
    finally:
        run.cleanup()
    limits = workload['limits']
    assert all(program[k] <= v for k, v in limits.items()), program
    assert any(control[k] > v for k, v in limits.items()), control
