"""CPU tests of the benchmark: small configurations of the cells' models,
torch on a few threads. Run with `python -m pytest perfbench/tests -q`;
the test marked `cuda` runs only on a machine with an NVIDIA card
(`python -m pytest perfbench/tests -m cuda`)."""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / 'perfbench'


def _json(rel: str):
    return json.loads((BENCH / rel).read_text())


def small_config(name: str):
    """The configuration file with its models cut to a size the CPU
    runs in seconds (the widths are the tests', not the cells')."""
    cfg = copy.deepcopy(_json(f'configs/{name}.json'))
    cfg['forward_tacotron']['model'].update(
        embed_dims=16, series_embed_dims=8, durpred_conv_dims=16,
        durpred_rnn_dims=8, pitch_conv_dims=16, pitch_rnn_dims=12,
        energy_conv_dims=16, energy_rnn_dims=8, prenet_dims=16, prenet_k=4,
        rnn_dims=16, postnet_dims=16, postnet_k=3)
    cfg['fast_pitch']['model'].update(
        durpred_d_model=16, durpred_d_fft=16, durpred_layers=2,
        pitch_d_model=16, pitch_d_fft=16, pitch_layers=2,
        energy_d_model=16, energy_d_fft=16, energy_layers=2, d_model=32,
        prenet_layers=2, prenet_fft=32, postnet_layers=2, postnet_fft=32)
    cfg['hifigan']['model']['upsample_initial_channel'] = 32
    return cfg


SMALL_TRAIN = {'kind': 'train_steps', 'batch_size': 4,
               'frames': [[20, 40, 8], [129, 140, 4]], 'phonemes': [10, 18],
               'val_items': 4}


def small_inputs(cell_name: str, **traffic_changes):
    """(bench, cell, cfg, traffic, workload) of a cell at the small size,
    as `perfbench/run.py:run_cell` takes them."""
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    config, traffic_name = cell_name.split('.')
    # a cell built and checked here but not (yet) in BENCHMARK.json
    cell = next((w for w in bench['workloads'] if w['name'] == cell_name),
                {'name': cell_name, 'config': config,
                 'traffic': traffic_name, 'chips': 1})
    cfg = small_config(cell['config'])
    traffic = _json(f'traffic/{cell["traffic"]}.json')
    if traffic['kind'] == 'train_steps':
        traffic = dict(SMALL_TRAIN)
    else:
        traffic = dict(traffic, rate_per_s=4.0, chars_max=60)
    traffic.update(traffic_changes)
    workload = _json(f'workloads/{cell_name}.json')
    workload = dict(workload, trace_steps=1, check_requests=6)
    return bench, cell, cfg, traffic, workload


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
