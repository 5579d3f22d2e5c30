"""The readings a cell's limits are set from, on the card at the cell's size.

    python3 port_bench/control.py --workload <cell> --seeds <n,n,...> --seconds <s>

For each seed, in one process: the cell's set-up and warm-up, a window of
``--seconds`` at the cell's own load (calls dispatched ahead, as in a run),
then the compared numbers of the kept answers twice: the program's (its
answers against the float64 reference) and the control's (the reference
with bfloat16 operands and result in the program's place). One JSON line a
seed on standard output. The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import harness

    cell = harness.find_cell(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        entry = harness.entry_class(cell.traffic)(cell.config, cell.traffic, seed, device)
        t_call, answer = harness.warm_up(entry, cell.traffic, device)
        offsets = harness.answers_to_keep(seed, cell.traffic, args.seconds, t_call)
        slots = harness.slots_for(offsets, answer)
        del answer
        run = harness.Run(setup_s=0.0)
        kept, _ = entry.window(int(cell.traffic["warmup_calls"]), args.seconds, offsets,
                               slots, run)
        entry.release()
        torch.cuda.empty_cache()
        limits = cell.traffic["limits"]
        program, _ = harness.check_answers(entry, kept, limits)
        control, _ = harness.check_answers(entry, kept, limits, "bfloat16")
        print(json.dumps({"workload": args.workload, "seed": seed, "calls": run.calls,
                          "answers": sorted(kept),
                          "program": {k: v["value"] for k, v in program.items()},
                          "control": {k: v["value"] for k, v in control.items()},
                          "limits": limits}), flush=True)
        del entry, kept
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
