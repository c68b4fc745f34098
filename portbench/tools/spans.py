"""One cell's traced stretch read by the port's spans: device ms a step by
owner span, host self ms and launch calls a step by span, the host's own
time a step, and the ten longest idle gaps with the span whose operation
ends each (portbench/harness/spans.py).

    python3 portbench/tools/spans.py --workload <cell> --seed <n> \
        [--out out/spans_<cell>.jsonl] [--device cpu --small]

The stretch is the one a ``run.py --trace 1`` run traces: the driver's
set-up, its warm steps under the profiler, then its traced steps inside
the harness's mark. The table goes to standard error; a JSON line (the
card, the six per-layer readings, the traced window a step, the
harness's record of the same events, the span record) to standard output
and to --out. --device cpu --small rehearses the tool on the CPU at the
cell's small traffic: no device operation is traced there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    build = os.path.join(REPO, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from nemo_tpu_torch.ops import reset_launches
    from portbench.harness.cell import cell_spec
    from portbench.harness.readers import load_module
    from portbench.harness.spans import readings, reduce_spans, table
    from portbench.harness.trace import MARK, reduce_events
    from portbench.tools.sets import smi

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    spec = cell_spec(args.workload)
    wl = spec["workload"]
    traffic = {**spec["traffic"], **(wl["small"] if args.small else {})}
    drv = load_module("drivers", wl["driver"]).Driver(
        spec["config"], traffic, args.seed, device, wl["limits"])
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        drv.warm_trace()
        reset_launches()
        with record_function(MARK):
            steps = drv.traced_steps()
    events = prof.events()
    rec = reduce_events(events, steps)
    sp = reduce_spans(events, steps)
    print(table(sp), file=sys.stderr)
    line = {"workload": args.workload, "seed": args.seed,
            "device": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu", "smi": smi(),
            "readings": readings(sp),
            "window_ms_per_step": rec["window_us"] / 1e3 / steps,
            "busy_ms_per_step": rec["busy_us"] / 1e3 / steps,
            "record": {k: v for k, v in rec.items() if k != "kernels"},
            "spans": sp}
    text = json.dumps(line)
    print(text)
    out = args.out or os.path.join(REPO, "out",
                                   f"spans_{args.workload}.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "a") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
