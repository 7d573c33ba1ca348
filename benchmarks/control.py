"""The control of the check that decides `correct`: the cell's reference,
computed in the precision below the configuration's, in the program's
place (the reference's `control_build`). Its poses must come out not
correct.

    python3 benchmarks/control.py --workload <name> --seeds 1,2,3 [--program]

For each seed it draws the cell's weights and frame pool as a run does,
takes `check_frames` frames of the pool in the cell's batches, as the
window sends them, and prints one JSON line with the check's numbers for
the control's poses and, with `--program`, for the program's (the system
under test called on the same batches), against the reference.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmarks import harness  # noqa: E402


def answers_of(pipe, system, pool, traffic):
    """The answers of `pipe` for the first `check_frames` frames of the
    pool, in the traffic's batches, brought to the host by `system`."""
    batch, out = traffic['batch'], []
    for i in range(-(-traffic['check_frames'] // batch)):
        lo = (i * batch) % pool.shape[0]
        answer = system.read(system.fetch(pipe(pool[lo:lo + batch])))
        out.append(dict(answer, frames=list(range(lo, lo + batch))))
    return out


def readings(cell, seed: int, devices, with_program: bool) -> dict:
    first = torch.device(devices[0])
    ref = cell.reference()
    params = ref.draw_params(cell.config, seed, first)
    pool = harness.draw_pool(cell.traffic, seed, first)
    on_cpu = devices if first.type == 'cpu' else None
    line = {'seed': seed}
    if with_program:
        system = cell.system()
        pipe = system.build(params, cell.config, cell.traffic, on_cpu)
        answers = answers_of(pipe, system, pool, cell.traffic)
        del pipe
        line['program'] = ref.judge(params, cell.config, cell.traffic, pool, answers, first)
    pipe = ref.CONTROL.build(params, cell.config, cell.traffic, on_cpu)
    answers = answers_of(pipe, ref.CONTROL, pool, cell.traffic)
    line['control'] = ref.judge(params, cell.config, cell.traffic, pool, answers, first)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True, help='comma-separated')
    ap.add_argument('--program', action='store_true',
                    help="also the program's readings on the same frames")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'control: {args.workload} needs {cell.chips} CUDA device(s)', file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    devices = [f'cuda:{i}' for i in range(cell.chips)]
    for seed in (int(s) for s in args.seeds.split(',')):
        print(json.dumps(dict(readings(cell, seed, devices, args.program),
                              workload=args.workload)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
