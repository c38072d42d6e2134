"""`python -m forwardtacotron_tpu_torch.tools.benchmark_serving` on the
CPU at a tiny width: 2 clients x 2 requests against the port's
`TTSServer` print one JSON line with the keys of the JAX package's
`tools/benchmark_serving.py` (read from its source) plus
`kernel_launches`, no errors and every request answered; staged with
Griffin-Lim and the launches counted, fused with HiFi-GAN (on the CPU the
fused function runs directly), and with the launch count off, as it is
by default."""
import ast
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _jax_keys():
    """The keys of the result dict that the JAX tool prints."""
    tree = ast.parse((ROOT / 'tools' / 'benchmark_serving.py').read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], 'id', None) == 'result':
            return {k.value for k in node.value.keys}
    raise AssertionError('no result dict in tools/benchmark_serving.py')


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    from test_torch_gen_forward import TINY_HIFI, N_MELS, _config
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.models.hifigan import (
        HiFiGANGenerator, weight_norm_state_dict)
    from forwardtacotron_tpu_torch.utils.checkpoints import save_checkpoint
    d = tmp_path_factory.mktemp('benchmark_serving')
    cfg = _config()
    torch.manual_seed(0)
    save_checkpoint(ForwardTacotron.from_config(cfg), None, cfg,
                    d / 'tts.pt', step=100)
    hifi = HiFiGANGenerator.from_config(TINY_HIFI, n_mels=N_MELS)
    torch.save({'generator': weight_norm_state_dict(hifi)}, d / 'g.pt')
    (d / 'config.json').write_text(json.dumps(TINY_HIFI))
    return d


@pytest.mark.parametrize('vocoder', [['griffinlim', '--count-launches'],
                                     ['hifigan', '--fused'],
                                     ['griffinlim']],
                         ids=['staged_griffinlim', 'fused_hifigan',
                              'no_launch_count'])
def test_two_clients_two_requests(files, vocoder, capsys):
    from forwardtacotron_tpu_torch.tools import benchmark_serving
    argv = ['--checkpoint', str(files / 'tts.pt'), '--vocoder', vocoder[0],
            '--clients', '2', '--requests', '2', '--max_batch', '2',
            '--device', 'cpu', *vocoder[1:]]
    if vocoder[0] == 'hifigan':
        argv += ['--voc_checkpoint', str(files / 'g.pt')]
    result = benchmark_serving.main(argv)
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith('{')]
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert printed == json.loads(json.dumps(result))
    assert set(printed) == _jax_keys() | {'kernel_launches'}
    assert printed['errors'] == 0 and printed['requests_total'] == 4
    assert printed['clients'] == 2 and printed['audio_s_per_s'] > 0
    lat = printed['latency_s']
    assert 0 < lat['p50'] <= lat['p95'] <= lat['p99'] <= lat['max']
    assert 1 <= printed['mean_batch_size'] <= 2
    # the plain versions run on the CPU: no kernel is launched
    assert printed['kernel_launches'] == ({
        'birnn_stream_local': 0, 'birnn_cooperative': 0,
        'wavernn_sample': 0} if '--count-launches' in argv else None)
