"""Run one cell of the benchmark once and print its result line.

    python -m benchmarks.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (`posenet_tpu_torch`),
on a machine with as many CUDA devices as the cell asks for; without them
it exits with an error and prints no result. The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` `breakdown`, and last `checks`, each number the
check compared beside its limit; the last lines of standard error repeat
the checks. Build and kernel caches stay in `.bench_cache/` and the
program's `posenet_tpu_torch/_build/`, inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Fixed cache directories inside the checkout, so that only a cell's first
# run there builds and compiles.
CACHE_DIRS = {'CUDA_CACHE_PATH': 'nv', 'TRITON_CACHE_DIR': 'triton',
              'TORCH_EXTENSIONS_DIR': 'torch_extensions', 'TORCHINDUCTOR_CACHE_DIR': 'inductor'}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / '.bench_cache' / sub)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    from benchmarks import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'benchmarks.run: {args.workload} needs {cell.chips} CUDA device(s), '
              f'found {found}; no result', file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    devices = [f'cuda:{i}' for i in range(cell.chips)]
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace), devices)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f'benchmarks.run: forbidden modules loaded: {loaded}; no result',
              file=sys.stderr)
        return 4
    for name, c in result['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
