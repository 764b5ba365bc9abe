"""The readings a cell's check limits are set from, at the cell's own size
on the chip, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--fault-seeds 7,8,9] [--seconds 2] [--out FILE]

* ``program``: the cell's run (set-up, a short window, the check) on each
  of ``--seeds``: the lower readings;
* ``control``: the plain reference in fp8 (e4m3, per-tensor scales on
  every conv's input and weight; ``reference.steps.fp8_quant``), one
  precision below the configuration's bf16, in the program's place: for a
  served field, in the runner's place inside the run; for training, its
  three steps' readings against the f32 reference's;
* ``half``: for training, the run with each step on half of its batch
  (``drivers.train.Observed``), on ``--fault-seeds``. A state left
  unchanged reads 1 on ``change_gap`` by the check's measure and needs no
  run.

Prints one JSON line per reading and, with ``--out``, writes them all.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from portbench import harness


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    kind = cell["mix"]["kind"]
    driver = importlib.import_module("portbench.drivers." + kind)
    device = torch.device("cuda")
    rows = []

    def emit(what, seed, numbers, extra=None):
        row = {"cell": args.workload, "what": what, "seed": seed, "numbers": numbers}
        row.update(extra or {})
        rows.append(row)
        print(json.dumps(row), flush=True)

    print(harness.card_line(), file=sys.stderr)
    for s in seeds(args.seeds):
        out = driver.run(cell, s, args.seconds, False, device, time.perf_counter())
        emit("program", s, out["numbers"],
             {"metrics": out["metrics"], "memory_peak_bytes": out["device"]["memory_peak_bytes"]})
    for s in seeds(args.control_seeds):
        if kind == "serve":
            out = driver.run(cell, s, args.seconds, False, device, time.perf_counter(),
                             fault="control")
            emit("control", s, out["numbers"])
        else:
            from portbench.reference.steps import fp8_quant

            pool_a, pool_b = driver.make_inputs(cell, s, device)
            low = driver.reference_readings(cell, s, device, pool_a, pool_b, fp8_quant)
            ref = driver.reference_readings(cell, s, device, pool_a, pool_b)
            emit("control", s, driver.numbers(low, ref))
            del pool_a, pool_b
            torch.cuda.empty_cache()
    for s in seeds(args.fault_seeds):
        out = driver.run(cell, s, args.seconds, False, device, time.perf_counter(), fault="half")
        emit("half", s, out["numbers"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": harness.card_line(), "torch": torch.__version__, "rows": rows},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
