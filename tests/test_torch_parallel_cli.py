"""`train_forward` under torchrun on the CPU: two processes with
torchrun's environment (MASTER_ADDR / MASTER_PORT on localhost,
WORLD_SIZE, RANK, LOCAL_RANK) bring up a gloo group through the CLI
(`parallel.training_device`), train the tiny student of
tests/test_torch_train_pipeline.py on its dataset over the global
batches' rows, and rank 0 alone writes the checkpoint, which loads and
matches the one-process CLI's after the same 6 steps (dropout and zoneout
0): the step and Adam's step counts equal, and the L2 distance of the
weights and running statistics from the one process's at most 1e-3 of
how far the one process moved them from the initial ones (measured
9.5e-5). Six Adam steps compound the float32 differences of near-zero
gradients (lr g / (|g| + eps)), so the steps themselves are held
element by element in tests/test_torch_parallel.py, one at a time.
"""
import json
import socket

import pytest
import torch

import torch_ranks
from test_torch_train_pipeline import TINY_MODEL, _make_dataset


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _config_file(tmp_path, data):
    import yaml
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['data_path'] = str(data)
    cfg['tts_model_id'] = 'ranks_tts'
    cfg['forward_tacotron']['model'] = dict(TINY_MODEL)
    cfg['forward_tacotron']['training'].update(
        schedule=['1e-3, 6, 4'], checkpoint_every=1000)
    path = tmp_path / 'tiny.yaml'
    # tuples as lists: the YAML a user would write
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return path


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_train_forward_under_torchrun(tmp_path, monkeypatch):
    from forwardtacotron_tpu_torch import train_forward
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    data = tmp_path / 'data'
    _make_dataset(data)
    config = _config_file(tmp_path, data)
    two, one = tmp_path / 'two_ranks', tmp_path / 'one_process'
    torch_ranks.run_ranks(torch_ranks.cli_rank, tmp_path, str(two),
                          str(config), _free_port(), group=False)
    for r in range(2):
        got = torch.load(two / f'cli_{r}.pt', weights_only=False)
        assert got == {'step': 6, 'world': 2, 'backend': 'gloo'}
    ckpt_dir = two / 'checkpoints' / 'ranks_tts.forward'
    assert sorted(p.name for p in ckpt_dir.glob('*.pt')) == [
        'latest_model.pt']

    for var in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK',
                'LOCAL_RANK'):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv('FTT_BASE', str(one))
    assert train_forward.main(['--config', str(config),
                               '--device', 'cpu']) == 6
    assert not torch.distributed.is_initialized()
    ranks = load_checkpoint(ckpt_dir / 'latest_model.pt')
    alone = load_checkpoint(one / 'checkpoints' / 'ranks_tts.forward'
                            / 'latest_model.pt')
    assert ranks['step'] == alone['step'] == 6
    assert [s['step'] for s in ranks['optim']['state'].values()] \
        == [s['step'] for s in alone['optim']['state'].values()]
    from forwardtacotron_tpu_torch.config import read_config
    from forwardtacotron_tpu_torch.utils.checkpoints import init_tts_model
    torch.manual_seed(train_forward.SEED)
    init = init_tts_model(read_config(config)).state_dict()
    apart = moved = 0.0
    for k, v in alone['model'].items():
        if v.is_floating_point():
            apart += float(((ranks['model'][k] - v) ** 2).sum())
            moved += float(((v - init[k]) ** 2).sum())
        else:
            assert torch.equal(ranks['model'][k], v), k
    print(f'two ranks against one process after 6 steps: {apart ** 0.5:.3g}'
          f' (L2); the one process moved {moved ** 0.5:.3g}')
    assert apart ** 0.5 <= 1e-3 * moved ** 0.5
