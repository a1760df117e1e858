"""The control of a cell's comparison, at the cell's own size.

    python3 -m portbench.control --workload <name> --seeds 11,12,13 --feeds <n>

For each seed the cell's inputs are made as a run makes them, and the
drive's control (its plain reference with one guarantee of the
configuration broken) stands in the program's place for *n* batches fed;
the drive's check then judges it.  One JSON line a seed.  A sound
comparison reads every control as not correct.  The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time

from portbench import spec
from portbench import trace as tr
from portbench.run import log


def control_of(cfg, traffic, seed, feeds, device):
    """The control's checks {name: (value, limit)} for one seed."""
    drive = spec.drive(traffic["drive"])
    run = drive.make(cfg, traffic, seed, device, tr.Spans(), log)
    return run.control(feeds)


def main(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--feeds", type=int, required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the control is read at the cell's size on "
            "the card")
        return 2
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        checks = control_of(cfg, traffic, seed, args.feeds,
                            torch.device("cuda", 0))
        correct = all(v <= lim for v, lim in checks.values())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "feeds": args.feeds, "correct": correct,
                          "seconds": time.perf_counter() - t,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
