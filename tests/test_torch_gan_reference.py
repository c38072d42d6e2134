"""The port's GAN training step (`train/hifigan_trainer.py:gan_train_step`)
against the benchmark's plain reference (`perfbench/reference/
hifigan_gan.py`) on the CPU: the generator at 32 channels, 1024-sample
segments, batch 2, the whole MPD and MSD, three steps from the same
seeded weights. The reference computed in bfloat16 fails the comparison;
the reference imports neither JAX nor the port; the model FLOPs of
`perfbench/harness/gan_flops.py` are what `FlopCounterMode` counts.

Tolerances, each from float32 on both sides (readings at this size: loss
7e-7, gradient 9e-4 worst leaf, change 1.9e-5 median leaf and 1.2e-2
worst; the bfloat16 reference reads 9.8e-3, 2.8e-2 to 5.4, 5.6e-2 to
1.7 and 0.31 to 2.0):

- losses, relative 1e-5: the port runs real and generated audio through
  the discriminators as one batch and generates twice a step, the
  reference runs them apart and once, so sums differ in order only;
- first gradients, each leaf's L2 gap over the larger of its norm and its
  net's median leaf norm, 5e-3: conv_post's bias sums some 2000
  tanh-weighted terms that cancel, which leaves it at 9e-4;
- the change after three steps, each leaf's L2 gap over the reference's
  change: 1e-3 for the median leaf and 0.05 for the worst, since AdamW's
  first steps move each element by about lr times its gradient's sign,
  and an element whose gradient is near 0 can take the other sign on a
  rounding.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[1]
HOP, SEG_LEN, B, STEPS = 256, 1024, 2, 3
TOL = {'loss': 1e-5, 'grad': 5e-3, 'change_median': 1e-3,
       'change_worst': 0.05}


@pytest.fixture(autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def small_config():
    cfg = json.loads((ROOT / 'perfbench/configs/hifigan_v1_ljspeech.json'
                      ).read_text())
    cfg['hifigan']['model']['upsample_initial_channel'] = 32
    return cfg


def _batches(seed=3):
    g = torch.Generator().manual_seed(seed)
    return [{'mel': torch.randn(B, 80, SEG_LEN // HOP, generator=g) * 2 - 5,
             'audio': (0.1 * torch.randn(B, SEG_LEN, generator=g)
                       ).clamp(-1, 1)} for _ in range(STEPS)]


@pytest.fixture(scope='module')
def port_run():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return _port_steps()
    finally:
        torch.set_num_threads(saved)


def _port_steps():
    """Three steps of the port from the reference's weights: the losses,
    each net's first gradients as AdamW got them, its weights after."""
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.models.gan_discriminators import \
        HiFiGANDiscriminators
    from forwardtacotron_tpu_torch.models.hifigan import make_generator
    from forwardtacotron_tpu_torch.train.hifigan_trainer import (
        gan_train_step, make_gan_optimizer)
    from perfbench.harness.gan_steps import draw_weights
    from perfbench.harness.train_steps import load_weights
    from perfbench.reference.hifigan_gan import LOSSES
    cfg = small_config()
    W = draw_weights(cfg, 7, 'cpu')
    nets = {'gen': make_generator(cfg).train(),
            'disc': HiFiGANDiscriminators().train()}
    opts = {}
    for k, net in nets.items():
        load_weights(net, W[k])
        opts[k] = make_gan_optimizer(net)
    to_mel = DSP.from_config(cfg, device='cpu').wav_to_mel_batch
    losses, first = [], {}
    for i, b in enumerate(_batches()):
        m = gan_train_step(nets['gen'], nets['disc'], opts['gen'],
                           opts['disc'], {'mel': b['mel'].transpose(1, 2),
                                          'audio': b['audio']}, to_mel)
        losses.append([float(m[k]) for k in LOSSES])
        if i == 0:
            first = {k: {n: opts[k].state[p]['exp_avg'].clone()
                         / (1 - opts[k].param_groups[0]['betas'][0])
                         for n, p in net.named_parameters()}
                     for k, net in nets.items()}
    final = {k: {n: p.detach().clone() for n, p in net.named_parameters()}
             for k, net in nets.items()}
    return {'cfg': cfg, 'W': W, 'losses': losses, 'first': first,
            'final': final}


def _gaps(run, dt):
    from perfbench.reference import hifigan_gan as ref
    cfg = run['cfg']
    out = ref.run_steps(run['W']['gen'], run['W']['disc'], _batches(),
                        cfg['hifigan']['model'], cfg['dsp'], 2e-4, dt)
    gaps = {'loss': max(abs(a - b) / abs(b) for got, want in
                        zip(run['losses'], out['losses'])
                        for a, b in zip(got, want))}
    for k in ('gen', 'disc'):
        want = out['first_grad'][k]
        norms = sorted(float(g.norm()) for g in want.values())
        median = norms[len(norms) // 2]
        gaps[f'grad_{k}'] = max(
            float((run['first'][k][n] - g).norm()) / max(float(g.norm()),
                                                         median)
            for n, g in want.items())
        change = sorted(
            float((run['final'][k][n] - w).norm())
            / float((w - run['W'][k][n]).norm())
            for n, w in out['final'][k].items())
        gaps[f'change_median_{k}'] = change[len(change) // 2]
        gaps[f'change_worst_{k}'] = change[-1]
    return gaps


def _over(gaps):
    return {k: v for k, v in gaps.items()
            if v > TOL[k.rsplit('_', 1)[0] if k != 'loss' else k]}


def test_three_steps_match_the_reference(port_run):
    gaps = _gaps(port_run, torch.float32)
    assert not _over(gaps), gaps


def test_a_bfloat16_reference_fails_the_comparison(port_run):
    over = _over(_gaps(port_run, torch.bfloat16))
    assert {'loss', 'grad_gen', 'change_median_gen'} <= set(over), over


# ---------------------------------------------------------------- imports

def test_the_reference_imports_no_jax_and_nothing_of_the_port():
    path = ROOT / 'perfbench/reference/hifigan_gan.py'
    allowed = {'__future__', 'math', 'pickle', 'pathlib', 'typing', 'numpy',
               'torch', 'perfbench'}
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ''] if isinstance(node, ast.ImportFrom)
                 else [])
        for name in names:
            assert name.split('.')[0] in allowed, name
            if name.startswith('perfbench'):
                assert name.startswith('perfbench.reference'), name
    script = '; '.join([
        f'import sys; sys.path.insert(0, {str(ROOT)!r})',
        'import perfbench.reference.hifigan_gan',
        'print(sorted({m.split(".")[0] for m in sys.modules}))'])
    out = subprocess.run([sys.executable, '-c', script], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    tops = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {'jax', 'jaxlib', 'flax', 'forwardtacotron_tpu',
                       'forwardtacotron_tpu_torch'}, tops


# ------------------------------------------------------------------ FLOPs

@pytest.mark.parametrize('channels,frames', [(32, 4), (512, 2)])
def test_forward_flops_match_the_flop_counter(channels, frames):
    from forwardtacotron_tpu_torch.models.gan_discriminators import \
        HiFiGANDiscriminators
    from forwardtacotron_tpu_torch.models.hifigan import make_generator
    from perfbench.harness import gan_flops
    cfg = small_config()
    cfg['hifigan']['model']['upsample_initial_channel'] = channels
    with torch.device('meta'):
        gen, disc = make_generator(cfg), HiFiGANDiscriminators()
        with FlopCounterMode(display=False) as count:
            y_hat = gen(torch.empty(B, 80, frames))
        assert count.get_total_flops() == gan_flops.generator_flops(
            cfg['hifigan']['model'], 80, B, frames)
        with FlopCounterMode(display=False) as count:
            disc(torch.empty_like(y_hat), y_hat)
        assert count.get_total_flops() == \
            gan_flops.discriminator_flops(2 * B, frames * HOP)


def test_a_steps_forwards_are_two_of_each_net():
    """The step's forward convolutions, as the port runs them, are two
    generations and two passes of the discriminators over real and
    generated audio; the model count (train.py's work) is 3 G + 4.5 D."""
    from perfbench.harness import gan_flops
    cfg = small_config()
    with FlopCounterMode(display=False) as count:
        _port_step(cfg)
    G = gan_flops.generator_flops(cfg['hifigan']['model'], 80, B,
                                  SEG_LEN // HOP)
    D = gan_flops.discriminator_flops(2 * B, SEG_LEN)
    forward = count.get_flop_counts()['Global'][torch.ops.aten.convolution]
    assert forward == 2 * G + 2 * D
    assert gan_flops.gan_step_flops(cfg, B, SEG_LEN) == 3 * G + 4.5 * D


def _port_step(cfg):
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.models.gan_discriminators import \
        HiFiGANDiscriminators
    from forwardtacotron_tpu_torch.models.hifigan import make_generator
    from forwardtacotron_tpu_torch.train.hifigan_trainer import (
        gan_train_step, make_gan_optimizer)
    gen, disc = make_generator(cfg).train(), HiFiGANDiscriminators().train()
    batch = {'mel': torch.randn(B, SEG_LEN // HOP, 80),
             'audio': 0.1 * torch.randn(B, SEG_LEN)}
    gan_train_step(gen, disc, make_gan_optimizer(gen),
                   make_gan_optimizer(disc), batch,
                   DSP.from_config(cfg, device='cpu').wav_to_mel_batch)


def _reference_step(cfg):
    from perfbench.harness.gan_steps import draw_weights
    from perfbench.reference import hifigan_gan as ref
    W = draw_weights(cfg, 7, 'cpu')
    ref.run_steps(W['gen'], W['disc'], _batches()[:1],
                  cfg['hifigan']['model'], cfg['dsp'], 2e-4)


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride,
                   _padding, _dilation, transposed, _output_padding,
                   _groups, output_mask, out_shape=None, **_):
    """A convolution's backward: its input's and its weight's gradients,
    each as many products as the forward (FlopCounterMode's own formula
    takes a grouped convolution's weight gradient at every group's
    channels)."""
    from torch.utils.flop_counter import conv_flop_count
    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def _first_layers(cfg, n):
    """(the generator's first convolution on B mels, the discriminators'
    eight first convolutions on n waveforms): the forward FLOPs of the
    layers whose input gradient autograd skips where the input needs
    none."""
    ch = cfg['hifigan']['model']['upsample_initial_channel']
    pre = 2 * B * (SEG_LEN // HOP) * 80 * ch * 7
    first = 0
    for p in (2, 3, 5, 7, 11):
        rows = (-(-SEG_LEN // p) + 2 * 2 - 5) // 3 + 1
        first += 2 * n * rows * p * 1 * 32 * 5
    t = SEG_LEN
    for i in range(3):
        if i:
            t = (t + 2 * 2 - 4) // 2 + 1
        first += 2 * n * t * 128 * 1 * 15
    return pre, first


@pytest.mark.parametrize('who', ['reference', 'port'])
def test_a_steps_convolutions_match_the_hand_count(who):
    """A hand count of the backward, against FlopCounterMode over one whole
    step. The reference does the model's work: G + 2 G for the generator
    (its backward's weight and input products, but no input gradient for
    the mels), D + 2 D for the discriminators' update (no input gradient
    for their first layers: the audio is detached) and D + 0.5 D for the
    generator's (the input products over the generated rows alone), the
    model count less those first layers' input gradients. The port
    generates once more without gradient (G) and takes the input products
    over the real rows too (0.5 D), which the model count leaves out."""
    from perfbench.harness import gan_flops
    cfg = small_config()
    aten = torch.ops.aten
    with FlopCounterMode(display=False, custom_mapping={
            aten.convolution_backward: _conv_backward}) as count:
        (_reference_step if who == 'reference' else _port_step)(cfg)
    got = count.get_flop_counts()['Global']
    G = gan_flops.generator_flops(cfg['hifigan']['model'], 80, B,
                                  SEG_LEN // HOP)
    D = gan_flops.discriminator_flops(2 * B, SEG_LEN)
    pre, first = _first_layers(cfg, 2 * B)
    want = gan_flops.gan_step_flops(cfg, B, SEG_LEN) - pre - first
    if who == 'port':
        want += G + 0.5 * D
    assert got[aten.convolution] + got[aten.convolution_backward] == want
