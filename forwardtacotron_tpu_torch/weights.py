"""Weights from the JAX package's checkpoints.

`load_fjax` reads a `.fjax` file (a pickle of numpy arrays plus the
config). `forward_tacotron_state_dict` / `fast_pitch_state_dict` /
`tacotron_state_dict` / `wavernn_state_dict` / `hifigan_state_dict` /
`discriminator_state_dict` / `deepmind_wavernn_state_dict` turn its flax
variables into this package's `state_dict` (`tts_state_dict` picks the TTS
model's), under the reference's torch key names (the official generator's
for HiFi-GAN, the hub model's for MelGAN), so
`load_state_dict(strict=True)` takes them as they are. The reference has
no multi-speaker model and no aligner: their parameters are named after
the port's modules (`_put_speaker`, `aligner_state_dict`). Layout
transforms: conv kernels (W, Cin, Cout) -> (Cout, Cin, W), transposed-conv
kernels (stored flipped, (W, Cin, Cout)) -> (Cin, Cout, W) unflipped,
dense kernels transposed, RNN gates already in the torch layout.

`load_optimizer_state` carries a `.fjax`'s optimizer state (its 'optim':
optax's flattened Adam or AdamW states) over into torch optimizers: each
moment goes through its parameter's key map and layout transform above,
and Adam's count becomes torch's `step`.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence, Union

import numpy as np
import torch

from forwardtacotron_tpu_torch.models.fast_pitch import positional_table


def load_fjax(path: Union[str, Path], use_ema: bool = True
              ) -> Dict[str, Any]:
    """{'model': flax variables (numpy), 'config', 'step', 'optim'} of a
    `.fjax` checkpoint, 'optim' the optimizer state's leaves or None. EMA
    weights, when the file has them, replace the raw parameters unless
    `use_ema=False`. Unpickling runs code from the file: load only
    checkpoints you trust."""
    with open(path, 'rb') as f:
        payload = pickle.load(f)
    variables = dict(payload['model'])
    ema = variables.pop('ema_params', None)
    if use_ema and ema:
        variables['params'] = ema
    return {'model': variables, 'config': payload['config'],
            'step': int(payload.get('step', 0)),
            'optim': payload.get('optim')}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _put_conv1d(out: Dict, name: str, p: Dict) -> None:
    out[f'{name}.weight'] = _t(np.transpose(np.asarray(p['kernel']),
                                            (2, 1, 0)))
    if 'bias' in p:
        out[f'{name}.bias'] = _t(p['bias'])


def _put_dense(out: Dict, name: str, p: Dict) -> None:
    out[f'{name}.weight'] = _t(np.asarray(p['kernel']).T)
    if 'bias' in p:
        out[f'{name}.bias'] = _t(p['bias'])


def _put_batchnorm(out: Dict, name: str, params: Dict, stats: Dict) -> None:
    out[f'{name}.weight'] = _t(params['scale'])
    out[f'{name}.bias'] = _t(params['bias'])
    out[f'{name}.running_mean'] = _t(stats['mean'])
    out[f'{name}.running_var'] = _t(stats['var'])
    out[f'{name}.num_batches_tracked'] = torch.tensor(0, dtype=torch.long)


def _put_rnn_dir(out: Dict, name: str, d: Dict, reverse: bool = False
                 ) -> None:
    sfx = '_reverse' if reverse else ''
    out[f'{name}.weight_ih_l0{sfx}'] = _t(d['w_ih'])
    out[f'{name}.weight_hh_l0{sfx}'] = _t(d['w_hh'])
    out[f'{name}.bias_ih_l0{sfx}'] = _t(d['b_ih'])
    out[f'{name}.bias_hh_l0{sfx}'] = _t(d['b_hh'])


def _put_birnn(out: Dict, name: str, p: Dict) -> None:
    _put_rnn_dir(out, name, p['fwd'])
    _put_rnn_dir(out, name, p['bwd'], reverse=True)


def _put_bn_conv(out: Dict, name: str, params: Dict, stats: Dict) -> None:
    _put_conv1d(out, f'{name}.conv', params['conv'])
    _put_batchnorm(out, f'{name}.bnorm', params['bnorm'], stats['bnorm'])


def _put_cbhg(out: Dict, name: str, params: Dict, stats: Dict, K: int,
              num_highways: int) -> None:
    for i in range(K):
        _put_bn_conv(out, f'{name}.conv1d_bank.{i}',
                     params[f'bank_{i + 1}'], stats[f'bank_{i + 1}'])
    _put_bn_conv(out, f'{name}.conv_project1', params['proj1'],
                 stats['proj1'])
    _put_bn_conv(out, f'{name}.conv_project2', params['proj2'],
                 stats['proj2'])
    _put_dense(out, f'{name}.pre_highway', params['pre_highway'])
    for i in range(num_highways):
        for w in ('W1', 'W2'):
            _put_dense(out, f'{name}.highways.{i}.{w}',
                       params[f'highway_{i}'][w])
    _put_birnn(out, f'{name}.rnn', params['rnn'])


def _put_speaker(out: Dict, params: Dict, preds=()) -> None:
    """A multi-speaker model's `speaker_embedding`, `speaker_proj` and
    each predictor's `spk_proj` (no bias), named after the port's modules
    (the reference has no multi-speaker model, so no names of its own);
    nothing for a single-speaker one."""
    if 'speaker_embedding' not in params:
        return
    out['speaker_embedding.weight'] = _t(
        params['speaker_embedding']['embedding'])
    _put_dense(out, 'speaker_proj', params['speaker_proj'])
    for pred in preds:
        _put_dense(out, f'{pred}.spk_proj', params[pred]['spk_proj'])


def _put_series_predictor(out: Dict, name: str, params: Dict,
                          stats: Dict) -> None:
    out[f'{name}.embedding.weight'] = _t(params['embedding']['embedding'])
    for i in range(3):
        _put_bn_conv(out, f'{name}.convs.{i}', params[f'conv_{i}'],
                     stats[f'conv_{i}'])
    _put_birnn(out, f'{name}.rnn', params['rnn'])
    _put_dense(out, f'{name}.lin', params['lin'])


def forward_tacotron_state_dict(variables: Dict[str, Any],
                                model_cfg: Dict[str, Any], step: int = 0
                                ) -> Dict[str, torch.Tensor]:
    """Flax ForwardTacotron variables ({'params', 'batch_stats'}, numpy)
    -> the port's state_dict, with a multi-speaker model's speaker
    parameters (`_put_speaker`)."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    out: Dict[str, torch.Tensor] = {
        'step': torch.tensor([int(step)], dtype=torch.long),
        'embedding.weight': _t(params['embedding']['embedding'])}
    _put_cbhg(out, 'prenet', params['prenet'], stats['prenet'],
              K=model_cfg['prenet_k'],
              num_highways=model_cfg['prenet_num_highways'])
    for pred in ('dur_pred', 'pitch_pred', 'energy_pred'):
        _put_series_predictor(out, pred, params[pred], stats[pred])
    _put_conv1d(out, 'pitch_proj', params['pitch_proj'])
    _put_conv1d(out, 'energy_proj', params['energy_proj'])
    _put_birnn(out, 'lstm', params['lstm'])
    _put_dense(out, 'lin', params['lin'])
    _put_cbhg(out, 'postnet', params['postnet'], stats['postnet'],
              K=model_cfg['postnet_k'],
              num_highways=model_cfg['postnet_num_highways'])
    _put_dense(out, 'post_proj', params['post_proj'])
    _put_speaker(out, params, ('dur_pred', 'pitch_pred', 'energy_pred'))
    return out


def _put_layer_norm(out: Dict, name: str, p: Dict) -> None:
    out[f'{name}.weight'] = _t(p['scale'])
    out[f'{name}.bias'] = _t(p['bias'])


def _put_forward_transformer(out: Dict, name: str, p: Dict,
                             n_layers: int) -> None:
    d_model = int(np.asarray(
        p['layer_0']['self_attn']['in_proj_weight']).shape[1])
    out[f'{name}.pos_encoder.scale'] = _t(p['pos_scale'])
    out[f'{name}.pos_encoder.pe'] = positional_table(d_model)
    _put_layer_norm(out, f'{name}.norm', p['norm'])
    for i in range(n_layers):
        block, lp = f'{name}.layers.{i}', p[f'layer_{i}']
        for key in ('in_proj_weight', 'in_proj_bias'):
            out[f'{block}.self_attn.{key}'] = _t(lp['self_attn'][key])
        _put_dense(out, f'{block}.self_attn.out_proj',
                   lp['self_attn']['out_proj'])
        _put_conv1d(out, f'{block}.conv1', lp['conv1'])
        _put_conv1d(out, f'{block}.conv2', lp['conv2'])
        _put_layer_norm(out, f'{block}.norm1', lp['norm1'])
        _put_layer_norm(out, f'{block}.norm2', lp['norm2'])


def fast_pitch_state_dict(variables: Dict[str, Any],
                          model_cfg: Dict[str, Any], step: int = 0
                          ) -> Dict[str, torch.Tensor]:
    """Flax FastPitch variables ({'params'}, numpy) -> the port's
    state_dict, key for key and value for value the JAX package's
    `export_fast_pitch` (the positional tables recomputed), with a
    multi-speaker model's speaker parameters (`_put_speaker`)."""
    params = variables['params']
    out: Dict[str, torch.Tensor] = {
        'step': torch.tensor([int(step)], dtype=torch.long),
        'embedding.weight': _t(params['embedding']['embedding'])}
    for pred, layers in (('dur_pred', 'durpred_layers'),
                         ('pitch_pred', 'pitch_layers'),
                         ('energy_pred', 'energy_layers')):
        p = params[pred]
        out[f'{pred}.embedding.weight'] = _t(p['embedding']['embedding'])
        _put_forward_transformer(out, f'{pred}.transformer',
                                 p['transformer'], model_cfg[layers])
        _put_dense(out, f'{pred}.lin', p['lin'])
    for net in ('prenet', 'postnet'):
        _put_forward_transformer(out, net, params[net],
                                 model_cfg[f'{net}_layers'])
    _put_conv1d(out, 'pitch_proj', params['pitch_proj'])
    _put_conv1d(out, 'energy_proj', params['energy_proj'])
    _put_dense(out, 'lin', params['lin'])
    _put_speaker(out, params, ('dur_pred', 'pitch_pred', 'energy_pred'))
    return out


def tts_state_dict(variables: Dict[str, Any], config: Dict[str, Any],
                   step: int = 0) -> Dict[str, torch.Tensor]:
    """The state_dict of the TTS model that `config['tts_model']` names
    (ForwardTacotron or FastPitch) from its flax variables."""
    model_type = config.get('tts_model', 'forward_tacotron')
    if model_type == 'forward_tacotron':
        return forward_tacotron_state_dict(
            variables, config['forward_tacotron']['model'], step)
    if model_type == 'fast_pitch':
        return fast_pitch_state_dict(variables, config['fast_pitch']['model'],
                                     step)
    raise ValueError(f'Model type not supported: {model_type}')


def _put_prenet(out: Dict, name: str, p: Dict) -> None:
    _put_dense(out, f'{name}.fc1', p['fc1'])
    _put_dense(out, f'{name}.fc2', p['fc2'])


def _put_cell(out: Dict, name: str, params: Dict, prefix: str) -> None:
    for key, jax_key in (('weight_ih', 'w_ih'), ('weight_hh', 'w_hh'),
                         ('bias_ih', 'b_ih'), ('bias_hh', 'b_hh')):
        out[f'{name}.{key}'] = _t(params[f'{prefix}_{jax_key}'])


def tacotron_state_dict(variables: Dict[str, Any], model_cfg: Dict[str, Any],
                        step: int = 0, r: int = 1
                        ) -> Dict[str, torch.Tensor]:
    """Flax Tacotron variables (numpy) -> the port's state_dict, with the
    `decoder.r` and `stop_threshold` buffers, and a multi-speaker
    teacher's `speaker_embedding` and `speaker_proj`."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    enc = params['encoder']
    out: Dict[str, torch.Tensor] = {
        'step': torch.tensor([int(step)], dtype=torch.long),
        'decoder.r': torch.tensor(int(r), dtype=torch.int),
        'stop_threshold': torch.tensor(
            float(model_cfg.get('stop_threshold', -11.0)),
            dtype=torch.float32),
        'encoder.embedding.weight': _t(enc['embedding']['embedding'])}
    _put_prenet(out, 'encoder.pre_net', enc['pre_net'])
    _put_cbhg(out, 'encoder.cbhg', enc['cbhg'], stats['encoder']['cbhg'],
              K=model_cfg['encoder_k'],
              num_highways=model_cfg['num_highways'])
    _put_dense(out, 'encoder_proj', params['encoder_proj'])
    _put_prenet(out, 'decoder.prenet', params['dec_prenet'])
    _put_conv1d(out, 'decoder.attn_net.conv', params['lsa_conv'])
    for k in ('L', 'W', 'v'):
        _put_dense(out, f'decoder.attn_net.{k}', params[f'lsa_{k}'])
    _put_cell(out, 'decoder.attn_rnn', params, 'attn_rnn')
    _put_dense(out, 'decoder.rnn_input', params['rnn_input'])
    _put_cell(out, 'decoder.res_rnn1', params, 'res_rnn1')
    _put_cell(out, 'decoder.res_rnn2', params, 'res_rnn2')
    _put_dense(out, 'decoder.mel_proj', params['mel_proj'])
    _put_cbhg(out, 'postnet', params['postnet'], stats['postnet'],
              K=model_cfg['postnet_k'],
              num_highways=model_cfg['num_highways'])
    _put_dense(out, 'post_proj', params['post_proj'])
    _put_speaker(out, params)
    return out


def wavernn_state_dict(variables: Dict[str, Any], model_cfg: Dict[str, Any],
                       step: int = 0) -> Dict[str, torch.Tensor]:
    """Flax WaveRNN variables (numpy) -> the port's state_dict."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    out: Dict[str, torch.Tensor] = {
        'step': torch.tensor([int(step)], dtype=torch.long)}
    rp = params['upsample']['resnet']
    rs = stats['upsample']['resnet']
    _put_conv1d(out, 'upsample.resnet.conv_in', rp['conv_in'])
    _put_conv1d(out, 'upsample.resnet.conv_out', rp['conv_out'])
    _put_batchnorm(out, 'upsample.resnet.batch_norm', rp['batch_norm'],
                   rs['batch_norm'])
    for i in range(model_cfg['res_blocks']):
        bp, bs = rp[f'res_{i}'], rs[f'res_{i}']
        _put_conv1d(out, f'upsample.resnet.layers.{i}.conv1', bp['conv1'])
        _put_conv1d(out, f'upsample.resnet.layers.{i}.conv2', bp['conv2'])
        for bn in ('batch_norm1', 'batch_norm2'):
            _put_batchnorm(out, f'upsample.resnet.layers.{i}.{bn}',
                           bp[bn], bs[bn])
    for i in range(len(model_cfg['upsample_factors'])):
        w = np.asarray(params['upsample'][f'up_conv_{i}'])
        out[f'upsample.up_layers.{2 * i + 1}.weight'] = \
            _t(w.reshape(1, 1, 1, -1))
    out['I.weight'] = _t(np.asarray(params['I_kernel']).T)
    out['I.bias'] = _t(params['I_bias'])
    for rnn_name in ('rnn1', 'rnn2'):
        _put_rnn_dir(out, rnn_name, {k: params[f'{rnn_name}_{k}']
                                     for k in ('w_ih', 'w_hh', 'b_ih',
                                               'b_hh')})
    for fc in ('fc1', 'fc2', 'fc3'):
        out[f'{fc}.weight'] = _t(np.asarray(params[f'{fc}_kernel']).T)
        out[f'{fc}.bias'] = _t(params[f'{fc}_bias'])
    return out


def _put_conv_transpose(out: Dict, name: str, p: Dict) -> None:
    k = np.asarray(p['kernel'])
    out[f'{name}.weight'] = _t(np.transpose(k, (1, 2, 0))[:, :, ::-1])
    out[f'{name}.bias'] = _t(p['bias'])


def hifigan_state_dict(variables: Dict[str, Any], config: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """Flax GAN generator variables (numpy; a full GAN train state's
    `generator` subtree is taken) -> the port's state_dict for
    `config['hifigan']['model']`'s generator type: HiFi-GAN under the
    official keys, MelGAN under the hub model's."""
    params = variables['params']
    params = params.get('generator', params)
    model_cfg = config['hifigan']['model']
    out: Dict[str, torch.Tensor] = {}
    if str(model_cfg.get('generator_type', 'hifigan')).lower() == 'melgan':
        n = len(model_cfg.get('upsample_rates', (8, 8, 2, 2)))
        _put_conv1d(out, 'generator.1', params['conv_pre'])
        for i in range(n):
            _put_conv_transpose(out, f'generator.{3 + 3 * i}',
                                params[f'ups_{i}'])
            res, stack = params[f'res_{i}'], f'generator.{4 + 3 * i}'
            for j in range(3):
                _put_conv1d(out, f'{stack}.blocks.{j}.2',
                            res[f'block_{j}_dilated'])
                _put_conv1d(out, f'{stack}.blocks.{j}.4',
                            res[f'block_{j}_out'])
                _put_conv1d(out, f'{stack}.shortcuts.{j}',
                            res[f'shortcut_{j}'])
        _put_conv1d(out, f'generator.{4 + 3 * n}', params['conv_post'])
        return out
    _put_conv1d(out, 'conv_pre', params['conv_pre'])
    _put_conv1d(out, 'conv_post', params['conv_post'])
    i = 0
    while f'ups_{i}' in params:
        _put_conv_transpose(out, f'ups.{i}', params[f'ups_{i}'])
        i += 1
    n = 0
    while f'resblocks_{n}' in params:
        for name, p in params[f'resblocks_{n}'].items():
            kind, j = name.rsplit('_', 1)          # convs1_0 -> convs1.0
            _put_conv1d(out, f'resblocks.{n}.{kind}.{j}', p)
        n += 1
    return out


def _put_conv2d(out: Dict, name: str, p: Dict) -> None:
    out[f'{name}.weight'] = _t(np.transpose(np.asarray(p['kernel']),
                                            (3, 2, 0, 1)))
    out[f'{name}.bias'] = _t(p['bias'])


def discriminator_state_dict(variables: Dict[str, Any],
                             periods=(2, 3, 5, 7, 11), n_scales: int = 3
                             ) -> Dict[str, torch.Tensor]:
    """Flax HiFi-GAN discriminator variables (numpy; a full GAN train
    state's `discriminator` subtree is taken) -> the state_dict of
    `models/gan_discriminators.py:HiFiGANDiscriminators`: `mpd_<p>.conv_i`
    -> `mpd.<j>.convs.i`, `msd_<i>.conv_j` -> `msd.<i>.convs.j`, and each
    `conv_post`; 2-D kernels (kh, kw, Cin, Cout) -> (Cout, Cin, kh, kw)."""
    params = variables['params']
    params = params.get('discriminator', params)
    out: Dict[str, torch.Tensor] = {}
    for name, subs, n_convs, put in (
            ('mpd', [f'mpd_{p}' for p in periods], 5, _put_conv2d),
            ('msd', [f'msd_{i}' for i in range(n_scales)], 7, _put_conv1d)):
        for j, sub in enumerate(subs):
            p = params[sub]
            for i in range(n_convs):
                put(out, f'{name}.{j}.convs.{i}', p[f'conv_{i}'])
            put(out, f'{name}.{j}.conv_post', p['conv_post'])
    return out


def _put_conv_stack(out: Dict, name: str, p: Dict) -> None:
    i = 0
    while f'Conv_{i}' in p:
        _put_conv1d(out, f'{name}.convs.{i}', p[f'Conv_{i}'])
        _put_layer_norm(out, f'{name}.norms.{i}', p[f'LayerNorm_{i}'])
        i += 1
    _put_dense(out, f'{name}.lin', p['Dense_0'])


def aligner_state_dict(variables: Dict[str, Any], step: int = 0
                       ) -> Dict[str, torch.Tensor]:
    """Flax Aligner variables (numpy) -> the state_dict of
    `align/aligner.py:Aligner` (`Embed_0` -> `embedding`, each encoder's
    `Conv_i` / `LayerNorm_i` / `Dense_0` -> `convs.i` / `norms.i` /
    `lin`)."""
    params = variables['params']
    out: Dict[str, torch.Tensor] = {
        'step': torch.tensor([int(step)], dtype=torch.long),
        'embedding.weight': _t(params['Embed_0']['embedding'])}
    for enc in ('text_enc', 'mel_enc'):
        _put_conv_stack(out, enc, params[enc])
    return out


def deepmind_wavernn_state_dict(variables: Dict[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """Flax DeepMindWaveRNN variables (numpy) -> the reference's
    `models/deepmind_version.py` keys: `R`, `I_coarse`, `I_fine` (no bias),
    `O1`..`O4` and `bias_u` / `bias_r` / `bias_e`."""
    params = variables['params']
    out: Dict[str, torch.Tensor] = {}
    for name in ('R', 'O1', 'O2', 'O3', 'O4', 'I_coarse', 'I_fine'):
        _put_dense(out, name, params[name])
    for name in ('bias_u', 'bias_r', 'bias_e'):
        out[name] = _t(params[name])
    return out


# -------------------------------------------------- the JAX leaf of each

# the modules whose parameters the converters above read from a JAX leaf
# named after the module (`wavernn_state_dict`: `I_kernel`, `fc1_bias`,
# ...), by the model's class: no rule of the JAX mesh matches such a name
_NAMED_LEAVES = {'WaveRNN': ('I', 'fc1', 'fc2', 'fc3')}


def _module_leaves(module: torch.nn.Module) -> Dict[str, tuple]:
    """{parameter name: (JAX leaf, torch dim)} of one module's own
    parameters as the converters above fill them: `_put_dense` and
    `_put_conv1d` / `_put_conv2d` put a kernel's last axis (its output
    features) at dim 0, `_put_conv_transpose` at dim 1, an embedding
    keeps it at dim 1, `_put_batchnorm` / `_put_layer_norm` fill the
    weight from 'scale' and the bias from 'bias', and `_put_rnn_dir` fills
    a BiRNN's packed gates from 'w_ih' ... 'b_hh' (gate axis, dim 0, as it
    is). `_put_cell` (the teacher's decoder cells) and `wavernn_state_dict`
    (WaveRNN's GRUs, `up_conv_i`) read leaves prefixed with the module's
    name, and every other parameter is its own leaf: these carry no dim."""
    from forwardtacotron_tpu_torch.models.layers import BiRNN
    nn = torch.nn
    if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        return {'weight': ('kernel', 0), 'bias': ('bias', 0)}
    if isinstance(module, nn.ConvTranspose1d):
        return {'weight': ('kernel', 1), 'bias': ('bias', 0)}
    if isinstance(module, nn.Embedding):
        return {'weight': ('embedding', 1)}
    if isinstance(module, (nn.BatchNorm1d, nn.LayerNorm)):
        return {'weight': ('scale', None), 'bias': ('bias', 0)}
    if isinstance(module, BiRNN):
        return {f'{name}_l0{sfx}': (leaf, 0)
                for name, leaf in (('weight_ih', 'w_ih'),
                                   ('weight_hh', 'w_hh'),
                                   ('bias_ih', 'b_ih'), ('bias_hh', 'b_hh'))
                for sfx in ('', '_reverse')}
    return {}


def jax_layout(model: torch.nn.Module) -> Dict[str, tuple]:
    """{parameter name: (the JAX leaf it is converted from, the torch dim
    that holds the axis the JAX mesh's rules look at)} for every parameter
    of `model`: the kernel's, the embedding's and the bias's last axis, the
    packed gates' first. The dim is None for a leaf no rule names."""
    named = _NAMED_LEAVES.get(type(model).__name__, ())
    out = {}
    for prefix, module in model.named_modules():
        leaves = _module_leaves(module)
        own = prefix.split('.')[0] in named
        for name, p in module.named_parameters(recurse=False):
            full = f'{prefix}.{name}' if prefix else name
            leaf, dim = leaves.get(name, (name, None))
            out[full] = (f'{prefix}_{leaf}', None) if own else (leaf, dim)
    return out


# ------------------------------------------------------- optimizer state

# optax's leaves of `inject_hyperparams(adam | adamw)` (the JAX trainers'
# `make_optimizer`, behind a `clip_by_global_norm` with no leaves, and
# `make_gan_optimizer`): the inject count, the hyperparameters in sorted
# key order, scale_by_adam's count, then mu and nu, each in the params
# tree's sorted-key order
ADAM_HYPERPARAMS = ('b1', 'b2', 'eps', 'eps_root', 'learning_rate')
ADAMW_HYPERPARAMS = ADAM_HYPERPARAMS + ('weight_decay',)


def _tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts in jax's flattening order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    return [tree]


def _tree_paths(tree, prefix: str = '') -> List[str]:
    if isinstance(tree, dict):
        return [path for k in sorted(tree)
                for path in _tree_paths(tree[k], f'{prefix}/{k}')]
    return [prefix]


def _tree_unflatten(tree, leaves: List[Any]):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(tree)


def split_optim_leaves(leaves: Sequence[Any], params_trees: Sequence[Dict],
                       hyperparams: Sequence[str] = ADAM_HYPERPARAMS
                       ) -> List[Dict[str, Any]]:
    """A `.fjax`'s 'optim' leaves -> one {'count', 'mu', 'nu'} per
    optimizer state, in the order they were flattened (one for
    the TTS models and WaveRNN, the generator's then the discriminators'
    for the GAN pair), `mu` and `nu` as trees of `params_trees`. The
    layout is derived from those trees: a leaf count or a moment shape
    that does not match raises."""
    n_params = [len(_tree_leaves(t)) for t in params_trees]
    sizes = [len(hyperparams) + 2 + 2 * n for n in n_params]
    if len(leaves) != sum(sizes):
        raise ValueError('Optimizer state in checkpoint does not match '
                         f'({len(leaves)} vs {sum(sizes)} leaves)')
    out, at = [], 0
    for params, n, size in zip(params_trees, n_params, sizes):
        part = [np.asarray(leaf) for leaf in leaves[at:at + size]]
        at += size
        head, mu, nu = part[:-2 * n], part[-2 * n:-n], part[-n:]
        if any(h.shape != () for h in head):
            raise ValueError('Optimizer state in checkpoint does not match: '
                             'a leaf before the moments is not a scalar')
        for path, p, m, v in zip(_tree_paths(params), _tree_leaves(params),
                                 mu, nu):
            if not np.shape(p) == m.shape == v.shape:
                raise ValueError(f'Optimizer state in checkpoint does not '
                                 f'match at {path}: moments {m.shape} / '
                                 f'{v.shape}, parameter {np.shape(p)}')
        out.append({'count': int(head[-1]),
                    'mu': _tree_unflatten(params, mu),
                    'nu': _tree_unflatten(params, nu)})
    return out


def optimizer_state_dict(moments: Dict[str, Any],
                         optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module,
                         to_state_dict: Callable[[Dict], Dict],
                         variables: Dict[str, Any]) -> Dict[str, Any]:
    """A torch Adam/AdamW `state_dict` for `optimizer` over `model`'s
    parameters from one entry of `split_optim_leaves`: `to_state_dict`
    (the model's converter, e.g. `lambda v: wavernn_state_dict(v, cfg)`)
    maps `variables` with its params replaced by mu, then by nu, so each
    moment takes its parameter's key and layout; Adam's count becomes
    `step`. The optimizer's param_groups (its learning rate) are kept."""
    mapped = {k: to_state_dict(dict(variables, params=moments[k]))
              for k in ('mu', 'nu')}
    index = {id(p): i for i, p in enumerate(
        q for group in optimizer.param_groups for q in group['params'])}
    state = {}
    for name, p in model.named_parameters():
        if id(p) not in index:
            continue
        if name not in mapped['mu']:
            raise KeyError(f'no moment in the checkpoint for {name}')
        state[index[id(p)]] = {
            'step': torch.tensor(float(moments['count'])),
            'exp_avg': mapped['mu'][name].to(p.dtype).reshape(p.shape),
            'exp_avg_sq': mapped['nu'][name].to(p.dtype).reshape(p.shape)}
    if len(state) != len(index):
        raise ValueError(f'{len(index) - len(state)} of the optimizer\'s '
                         'parameters are not parameters of the model')
    return {'state': state,
            'param_groups': optimizer.state_dict()['param_groups']}


def load_optimizer_state(payload: Dict[str, Any], entries: Sequence[tuple],
                         hyperparams: Sequence[str] = ADAM_HYPERPARAMS
                         ) -> bool:
    """Restore torch optimizers from a `load_fjax` payload's 'optim'.
    `entries` holds one (optimizer, model, variables, to_state_dict) per
    optax state, in the order the JAX trainer flattened them; `variables`
    are the flax variables of that optimizer's parameters (raw, not EMA).
    False, and nothing changed, when the file has no optimizer state
    (written with `optim: None`): the optimizers start fresh, as in JAX."""
    if payload.get('optim') is None:
        return False
    parts = split_optim_leaves(payload['optim'],
                               [e[2]['params'] for e in entries], hyperparams)
    for (optimizer, model, variables, to_state_dict), part in zip(entries,
                                                                  parts):
        optimizer.load_state_dict(optimizer_state_dict(
            part, optimizer, model, to_state_dict, variables))
    return True
