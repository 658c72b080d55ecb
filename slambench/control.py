"""The control of the comparison: the plain reference in TF32 (the
precision just below the configurations' float32 with TF32 off) put in the
program's place, read beside the program's own numbers, on several seeds
in one process.

    python3 slambench/control.py --config <name> [--traffic seq] \
        --seeds 1,2,3 --seconds <s>

Each seed runs the configuration's set-up and a short window of the program's loop
(long enough to pass the sampled frames), then reads every compared
number twice: the program against the reference, and the control against
the reference. One JSON line a seed on standard output. The benchmark's
own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="seq")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    from slambench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = harness.run_cell(f"{args.config}.{args.traffic}", seed,
                             args.seconds, False, t, control=True,
                             spec=harness.cell_files(harness.ROOT,
                                                     args.config,
                                                     args.traffic))
        line = {"config": args.config, "seed": seed,
                "correct": r["correct"],
                "program": {k: v["value"] for k, v in r["checks"].items()},
                "control": r["control"],
                "details": r["info"]["details"],
                "control_details": r["control_details"], "limits": {
                    k: v["limit"] for k, v in r["checks"].items()},
                "device": r["device"]["kind"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
