"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: `forwardtacotron_tpu_torch` begins with
`forwardtacotron_tpu`."""
import ast
import json
import subprocess
import sys

from perfbench.harness.common import FORBIDDEN
from perfbench.tests.conftest import BENCH, ROOT

PORT = 'forwardtacotron_tpu_torch'
# the port's modules that the harness's traffic generators import
PORT_MODULES = ('serving', 'train.common', 'train.forward_trainer',
                'data.dataset', 'models.fast_pitch', 'models.forward_tacotron',
                'models.hifigan', 'kernels.birnn', 'kernels.birnn_train')


def _loaded_after(code: str):
    script = '\n'.join([
        'import sys', f'sys.path.insert(0, {str(ROOT)!r})', code,
        'import json',
        'print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))'])
    out = subprocess.run([sys.executable, '-c', script], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_what_a_run_loads_holds_no_jax():
    readers = [p.stem for p in (BENCH / 'metrics').glob('*.py')]
    code = '\n'.join(
        ['import perfbench.run as r, perfbench.calibrate',
         'import perfbench.harness.train_steps, '
         'perfbench.harness.poisson_open, perfbench.harness.trace']
        + [f'r.reader({n!r})' for n in readers]
        + [f'import {PORT}.{m}' for m in PORT_MODULES])
    tops = _loaded_after(code)
    assert PORT in tops
    assert not tops.intersection(FORBIDDEN), tops.intersection(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    refs = [p.stem for p in (BENCH / 'reference').glob('*.py')
            if p.stem != '__init__']
    tops = _loaded_after('\n'.join(f'import perfbench.reference.{m}'
                                    for m in refs))
    assert PORT not in tops
    assert not tops.intersection(FORBIDDEN)


def test_the_reference_imports_only_torch_numpy_and_itself():
    allowed = {'__future__', 'json', 'math', 'pickle', 'pathlib', 'typing',
               'numpy', 'torch', 'perfbench'}
    for path in (BENCH / 'reference').glob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            for name in names:
                top = name.split('.')[0]
                assert top in allowed, (path.name, name)
                if top == 'perfbench':
                    assert name.startswith('perfbench.reference'), \
                        (path.name, name)


def test_forbidden_names_are_compared_whole():
    from perfbench.harness import common
    sys.modules.setdefault('forwardtacotron_tpu_torch_probe', sys)
    try:
        assert 'forwardtacotron_tpu' not in common.forbidden_modules()
    finally:
        del sys.modules['forwardtacotron_tpu_torch_probe']
