"""The control of a cell's check: the plain reference computed in TF32
(the precision below the configuration's float32 with TF32 off) put in the
program's place, on the blocks a run of the cell would check, against the reference
in float64. It has to come out as not correct; its smallest reading over
the seeds is each limit's upper end.

    python3 rfbench/control.py --workload <cell> --seeds 1 2 3 [--window-blocks N]

Runs at the cell's own sizes on the device it finds (the card, else the
CPU); prints a line per seed and a JSON summary last.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import json  # noqa: E402

from rfbench import harness  # noqa: E402


def control_readings(cell_name: str, seed: int, window_blocks: int, device: str,
                     cell: dict | None = None, sizes: dict | None = None) -> dict:
    """{check name: the TF32 reference's worst number} over the blocks a
    run of ``window_blocks`` blocks would check (the same draw from the
    seed), each from the same fresh state as the check."""
    from rfbench.compare import compare
    from rfbench.reference.plain import F64, TF32

    cell = cell if cell is not None else harness.load_cell(cell_name)
    sizes = sizes if sizes is not None else harness.load_sizes(cell["config"])
    cfg = harness.module("configs", cell["config"])
    ctx = harness.Context(cell_name, cell, sizes, cfg, seed, 0.0, False, device, 0.0)
    ctx.pool = harness.make_pool(ctx)
    keep = harness.Keep(cell["check"]["sample"], seed)
    blocks = {cell["warm_blocks"] + window_blocks - 1}
    for i in range(window_blocks):
        if keep.wants() is not None:
            blocks.add(cell["warm_blocks"] + i)
    ref = cfg.reference(sizes, device)
    worst = {}
    for k in sorted(blocks):
        outs = [harness.reference_outputs(ref, ctx, k, lambda j: cfg.block(ctx.pool, j), p)
                for p in (TF32, F64)]
        nums = compare(*outs, cfg.CHECKS, cfg.modes(sizes), cfg.nfm_period(sizes))
        for n, v in nums.items():
            worst[n] = max(worst.get(n, 0.0), v)
    return worst


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--window-blocks", type=int, default=200)
    args = ap.parse_args()
    device = "cuda" if torch.cuda.is_available() else "cpu"
    limits = harness.load_cell(args.workload)["check"]["limits"]
    rows = {}
    for seed in args.seeds:
        t = time.perf_counter()
        r = control_readings(args.workload, seed, args.window_blocks, device)
        rows[seed] = r
        fails = [n for n, v in r.items() if not v <= limits[n]]
        print(f"control {args.workload} seed {seed}: "
              + ", ".join(f"{n} {v:.4g} (limit {limits[n]:g})" for n, v in r.items())
              + f"; fails {fails or 'NONE'} ({time.perf_counter() - t:.1f} s)", flush=True)
    least = {n: min(r[n] for r in rows.values()) for n in next(iter(rows.values()))}
    print(json.dumps({"workload": args.workload, "device": device, "readings": rows,
                      "least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
