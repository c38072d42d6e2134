#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; its configuration
(`perfbench/configs/`), its traffic mix (`perfbench/traffic/<name>.json`,
whose `kind` names the generator in `perfbench/harness/`), its own
settings and limits (`perfbench/workloads/<cell>.json`) and its per-layer
readers (`perfbench/metrics/<metric>.py`) are found by name. With
`--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a profiled slice of the run.
Every run checks what its timed path produced against the plain
reference after the window; the numbers compared and their limits come
last on standard error and under the result's last key.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def reader(name: str):
    """The per-layer metric's reader, perfbench/metrics/<name>.py."""
    from perfbench.harness.common import BENCH_DIR
    path = BENCH_DIR / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        'perfbench_metric_' + name.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_inputs(name: str):
    """(cell, configuration, traffic, workload settings) of a cell."""
    from perfbench.harness import common
    bench = common.load_benchmark()
    cell = common.cell_of(bench, name)
    entry = next(c for c in bench['configs'] if c['name'] == cell['config'])
    cfg = json.loads((common.ROOT / entry['file']).read_text())
    traffic = common.read_json(f'traffic/{cell["traffic"]}.json')
    workload = common.read_json(f'workloads/{cell["name"]}.json')
    return bench, cell, cfg, traffic, workload


def run_cell(args, device: str = 'cuda', inputs=None):
    """Set-up, window, readings and check of one run; the result line's
    fields, the compared numbers with their limits, and the notes.
    `inputs` stands in for `cell_inputs(args.workload)` (the tests' small
    configurations on the CPU)."""
    bench, cell, cfg, traffic, workload = inputs or cell_inputs(args.workload)
    kind = importlib.import_module(f'perfbench.harness.{traffic["kind"]}')
    out = kind.run(cfg, traffic, workload, args, T_START, device)
    from perfbench.harness.common import metrics_of
    metrics = {}
    if args.trace:
        for m in metrics_of(bench, cell['name'], 'per_layer'):
            value = reader(m['name'])(out['ctx'])
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        for m in metrics_of(bench, cell['name'], 'end_to_end'):
            metrics[m['name']] = {'value': out['e2e'][m['name']],
                                  'unit': m['unit']}
    limits = workload['limits']
    check = {k: {'value': v, 'limit': limits[k]}
             for k, v in out['check'].items() if k in limits}
    notes = out['notes'] + [f'reading {k} {v!r} (not compared)'
                            for k, v in out['check'].items()
                            if k not in limits]
    correct = all(math.isfinite(r['value']) and r['value'] <= r['limit']
                  for r in check.values())
    result = {'correct': correct, 'attempted': out['attempted'],
              'failed': out['failed'], 'metrics': metrics,
              'device': out['device']}
    trace = out['ctx'].get('trace')
    if args.trace and trace is not None:
        result['breakdown'] = {'device_ops': trace['device_ops'],
                               'idle_gaps': trace['idle_gaps']}
    return result, check, notes


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench.harness import common
    common.set_cache_dirs()
    _, cell, _, _, _ = cell_inputs(args.workload)
    import torch  # noqa: F401  (its import is part of the set-up)
    imported = time.perf_counter() - T_START
    common.require_cards(int(cell['chips']))
    result, check, notes = run_cell(args)
    found = common.forbidden_modules()
    if found:
        sys.stderr.write(f'perfbench: the process loaded {found}; no '
                         'result\n')
        return 5
    notes = notes + [f'process: torch imported after {imported!r} s',
                     f'card: {common.nvidia_smi_line()}']
    common.emit(result, check, notes)
    return 0


if __name__ == '__main__':
    sys.exit(main())
