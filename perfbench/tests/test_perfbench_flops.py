"""The FLOP and byte counters against hand counts and against torch's
own count of the reference's products at a small shape."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness import flops
from perfbench.harness.weights import draw
from perfbench.reference import fast_pitch as ref_fp
from perfbench.reference import forward_tacotron as ref_ft
from perfbench.tests.conftest import small_config


def _batch(B, Tx, Tm, n_chars=135):
    g = torch.Generator().manual_seed(0)
    x = torch.randint(1, n_chars, (B, Tx), generator=g)
    dur = torch.full((B, Tx), Tm // Tx, dtype=torch.float32)
    return {'x': x, 'x_len': torch.full((B,), Tx), 'mel': torch.randn(
        B, Tm, 80, generator=g), 'mel_len': torch.full((B,), Tm),
        'dur': dur, 'pitch': torch.randn(B, Tx, generator=g),
        'energy': torch.randn(B, Tx, generator=g)}


def _counted(fn):
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn()
    return counter.get_total_flops()


def test_forward_tacotron_flops_match_torchs_count():
    cfg = small_config('ftw_ljspeech')
    P = draw(ref_ft.weight_spec(cfg), 1, 'cpu')
    B, Tx, Tm = 2, 10, 40
    batch = _batch(B, Tx, Tm)
    torch.manual_seed(0)
    counted = _counted(lambda: ref_ft.forward(P, batch, cfg))
    assert flops.forward_tacotron_forward_flops(cfg, B, Tx, Tm) == counted
    assert flops.train_step_flops(dict(cfg, tts_model='forward_tacotron'),
                                  B, Tx, Tm) == 3 * counted


def test_fast_pitch_flops_match_torchs_count():
    cfg = small_config('fph_ljspeech')
    P = draw(ref_fp.weight_spec(cfg), 1, 'cpu')
    B, Tx, Tm = 2, 10, 40
    batch = _batch(B, Tx, Tm)
    gen = torch.Generator().manual_seed(0)
    counted = _counted(lambda: ref_fp.forward(P, batch, cfg, gen))
    assert flops.fast_pitch_forward_flops(cfg, B, Tx, Tm) == counted


def test_conv_and_recurrence_hand_counts():
    # a k=3 conv of 4 -> 5 channels over 2 x 7 frames: 2 * 2 * 7 * 4 * 5 * 3
    assert flops._conv(2, 7, 4, 5, 3) == 1680
    # an even kernel computes one frame more
    assert flops._conv(1, 7, 1, 1, 2) == 2 * 8 * 2
    # a BiGRU, D=4, H=3, B=2, T=5: input 2*2*5*4*9 and hidden 2*2*5*3*9,
    # both directions
    assert flops._birnn(2, 5, 4, 3, 3) == 2 * (720 + 540)


def test_training_kernel_bounds_by_hand():
    # GRU, T=4, B=2, H=3, lengths (4, 2), two streams
    fwd, bwd = flops.birnn_train_bounds('gru', 4, 2, 3, [4, 2])
    active = 2 * (4 + 2)
    ops = 2.0 * active * 3 * 3 * 3
    gi = 4 * 2 * 2 * 9
    small = (2 * 9 * 3 + 2 * 9 + 2) * 4
    fwd_bytes = (gi + 2 * 4 * 2 * 3 * 6) * 4 + small
    bwd_bytes = (4 * 2 * 2 * 5 * 3 + 4 * 2 * 2 * 3 + 2 * gi) * 4 + small
    assert fwd == max(fwd_bytes / flops.HBM_BYTES_PER_S,
                      ops / flops.PEAK_FLOPS['fp32'])
    assert bwd == max(bwd_bytes / flops.HBM_BYTES_PER_S,
                      ops / flops.PEAK_FLOPS['fp32'])
    assert flops.bound_s(3.35e12, 1.0, 'bf16') == (1.0, 'bytes')
    assert flops.bound_s(1.0, 989e12, 'bf16') == (1.0, 'operations')
