"""Built-in copy of the config sections the port needs.

The machine that runs the port has no `pyyaml`, so the `data_path`,
model ids, `tts_model`, `dsp`, `preprocessing`, and the model and
training sections of `tacotron`, `aligner`, `forward_tacotron`,
`fast_pitch`, `vocoder` and `hifigan` of the repository's `config.yaml`
live here as plain dicts. A YAML file is read only by `read_config`, and
only where `yaml` can be imported.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

DSP = {
    'sample_rate': 22050,
    'n_fft': 1024,
    'num_mels': 80,
    'hop_length': 256,
    'win_length': 1024,
    'fmin': 0,
    'fmax': 8000,
    'peak_norm': False,
    'trim_start_end_silence': True,
    'trim_silence_top_db': 60,
    'pitch_max_freq': 600,
    'trim_long_silences': False,
    'vad_window_length': 30,
    'vad_moving_average_width': 8,
    'vad_max_silence_length': 12,
    'vad_sample_rate': 16000,
    'voc_mode': 'RAW',
    'bits': 9,
    'mu_law': True,
}

PREPROCESSING = {
    'seed': 42,
    'n_val': 200,
    'language': 'en-us',
    'cleaner_name': 'english_cleaners',
    'use_phonemes': True,
    'min_text_len': 2,
    'extract_durations_with_dijkstra': True,
}

TACOTRON_MODEL = {
    'embed_dims': 256,
    'encoder_dims': 128,
    'decoder_dims': 256,
    'postnet_dims': 128,
    'encoder_k': 16,
    'lstm_dims': 512,
    'postnet_k': 8,
    'num_highways': 4,
    'dropout': 0.5,
    'stop_threshold': -11,
}

TACOTRON_TRAINING = {
    'schedule': ['5,  1e-3,  10_000,  32', '3,  1e-4,  20_000,  16',
                 '2,  1e-4,  30_000,  8', '1,  1e-4,  40_000,  8'],
    'max_mel_len': 1250,
    'grad_accum': 1,
    'remat': False,
    'clip_grad_norm': 1.0,
    'checkpoint_every': 10000,
    'plot_every': 1000,
}

FORWARD_TACOTRON_MODEL = {
    'embed_dims': 256,
    'series_embed_dims': 64,
    'durpred_conv_dims': 256,
    'durpred_rnn_dims': 64,
    'durpred_dropout': 0.5,
    'pitch_conv_dims': 256,
    'pitch_rnn_dims': 128,
    'pitch_dropout': 0.5,
    'pitch_strength': 1.0,
    'energy_conv_dims': 256,
    'energy_rnn_dims': 64,
    'energy_dropout': 0.5,
    'energy_strength': 1.0,
    'prenet_dims': 256,
    'prenet_k': 16,
    'prenet_dropout': 0.5,
    'prenet_num_highways': 4,
    'rnn_dims': 512,
    'postnet_dims': 256,
    'postnet_k': 8,
    'postnet_num_highways': 4,
    'postnet_dropout': 0.0,
}

FORWARD_TACOTRON_TRAINING = {
    'schedule': ['5e-5,  150_000,  32', '1e-5,  300_000,  32'],
    'dur_loss_factor': 0.1,
    'pitch_loss_factor': 0.1,
    'energy_loss_factor': 0.1,
    'pitch_zoneout': 0.0,
    'energy_zoneout': 0.0,
    'max_mel_len': 1250,
    'clip_grad_norm': 1.0,
    'precision': 'f32',
    'ema_decay': 0.0,
    'grad_accum': 1,
    'remat': False,
    'checkpoint_every': 10_000,
    'plot_every': 1000,
    'filter_attention': True,
    'min_attention_sharpness': 0.5,
    'min_attention_alignment': 0.95,
}

FAST_PITCH_MODEL = {
    'durpred_d_model': 128,
    'durpred_n_heads': 2,
    'durpred_layers': 4,
    'durpred_d_fft': 128,
    'durpred_dropout': 0.5,
    'pitch_d_model': 128,
    'pitch_n_heads': 2,
    'pitch_layers': 4,
    'pitch_d_fft': 128,
    'pitch_dropout': 0.5,
    'pitch_strength': 1.0,
    'energy_d_model': 128,
    'energy_n_heads': 2,
    'energy_layers': 4,
    'energy_d_fft': 128,
    'energy_dropout': 0.5,
    'energy_strength': 1.0,
    'd_model': 256,
    'conv1_kernel': 9,
    'conv2_kernel': 1,
    'prenet_layers': 4,
    'prenet_heads': 2,
    'prenet_fft': 1024,
    'prenet_dropout': 0.1,
    'postnet_layers': 4,
    'postnet_heads': 2,
    'postnet_fft': 1024,
    'postnet_dropout': 0.1,
}

FAST_PITCH_TRAINING = {
    'schedule': ['1e-5,  5_000,  32', '5e-5,  100_000,  32',
                 '2e-5,  300_000,  32'],
    'dur_loss_factor': 0.1,
    'pitch_loss_factor': 0.1,
    'energy_loss_factor': 0.1,
    'pitch_zoneout': 0.0,
    'energy_zoneout': 0.0,
    'max_mel_len': 1250,
    'clip_grad_norm': 1.0,
    'precision': 'f32',
    'ema_decay': 0.0,
    'grad_accum': 1,
    'remat': False,
    'checkpoint_every': 10_000,
    'plot_every': 1000,
    'filter_attention': True,
    'min_attention_sharpness': 0.5,
    'min_attention_alignment': 0.95,
}

HIFIGAN_MODEL = {
    'generator_type': 'hifigan',
    'resblock': '1',
    'upsample_rates': [8, 8, 2, 2],
    'upsample_kernel_sizes': [16, 16, 4, 4],
    'upsample_initial_channel': 512,
    'resblock_kernel_sizes': [3, 7, 11],
    'resblock_dilation_sizes': [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}

VOCODER_MODEL = {
    'mode': 'RAW',
    'upsample_factors': [4, 8, 8],
    'rnn_dims': 512,
    'fc_dims': 512,
    'compute_dims': 128,
    'res_out_dims': 128,
    'res_blocks': 10,
    'pad': 2,
}


VOCODER_TRAINING = {
    'schedule': ['1e-4,  300_000,  32', '1e-5,  600_000,  32'],
    'checkpoint_every': 25_000,
    'gen_samples_every': 5000,
    'num_gen_samples': 3,
    'keep_top_k': 3,
    'seq_len': 1280,
    'clip_grad_norm': 4,
    'precision': 'f32',
    'remat': False,
    'max_mel_len': 20000,
    'gen_batched': True,
    'target': 11_000,
    'overlap': 550,
}

ALIGNER_MODEL = {
    'embed_dims': 128,
    'conv_dims': 128,
    'key_dims': 64,
    'n_text_convs': 3,
    'n_mel_convs': 2,
    'dropout': 0.1,
    'prior_width': 10.0,
}

ALIGNER_TRAINING = {
    'schedule': ['1e-3,  5_000,  32', '3e-4,  10_000,  32'],
    'max_mel_len': 1250,
    'clip_grad_norm': 1.0,
    'checkpoint_every': 2000,
}

HIFIGAN_TRAINING = {
    'schedule': ['2e-4,  400_000,  16', '1e-4,  800_000,  16'],
    'checkpoint_every': 25_000,
    'gen_samples_every': 5000,
    'num_gen_samples': 3,
    'keep_top_k': 3,
    'seg_len': 8192,
    'precision': 'f32',
    'max_mel_len': 20000,
}


# the mesh of data-parallel training (`parallel/mesh.py`): 'data' -1 spans
# every rank; 'model' (tensor parallelism) must be 1 in the port
TPU = {'mesh': {'data': -1, 'model': 1}}


def default_config() -> Dict[str, Any]:
    """A fresh copy of the built-in config (callers may mutate it)."""
    return copy.deepcopy({
        'voc_model_id': 'ljspeech_voc',
        'tts_model_id': 'ljspeech_tts',
        'data_path': 'data/',
        'tts_model': 'forward_tacotron',
        'dsp': DSP,
        'preprocessing': PREPROCESSING,
        'tacotron': {'model': TACOTRON_MODEL, 'training': TACOTRON_TRAINING},
        'aligner': {'model': ALIGNER_MODEL, 'training': ALIGNER_TRAINING},
        'forward_tacotron': {'model': FORWARD_TACOTRON_MODEL,
                             'training': FORWARD_TACOTRON_TRAINING},
        'fast_pitch': {'model': FAST_PITCH_MODEL,
                       'training': FAST_PITCH_TRAINING},
        'vocoder': {'model': VOCODER_MODEL, 'training': VOCODER_TRAINING},
        'hifigan': {'model': HIFIGAN_MODEL, 'training': HIFIGAN_TRAINING},
        'tpu': TPU,
    })


def read_config(path) -> Dict[str, Any]:
    """Read a YAML config (needs `pyyaml`, which the CLI imports only
    when `--config` is given), or a JSON one (a path ending in `.json`,
    which needs nothing beyond the standard library)."""
    if str(path).endswith('.json'):
        import json
        with open(path, encoding='utf-8') as f:
            return json.load(f)
    import yaml
    with open(path, encoding='utf-8') as f:
        return yaml.safe_load(f)
