"""Run one cell of the port's benchmark on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With --trace 0 the result line carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics from a stretch under torch.profiler. The
last line of standard output is the result's JSON object; the numbers that
decided ``correct`` close standard error, each beside its limit. With no
card, or fewer than the cell asks for, the run fails and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _json_safe(x):
    """Non-finite numbers as null: JSON has no inf or nan."""
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's build caches stay at fixed paths inside the checkout
    build = os.path.join(REPO, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    sys.path.insert(0, REPO)
    parts = {"start": time.perf_counter() - T_START}
    import torch
    from portbench.harness.cell import cell_spec, forbidden_modules, run_cell
    parts["import_torch"] = time.perf_counter() - T_START - parts["start"]

    chips = cell_spec(args.workload)["entry"]["chips"]
    t = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell {args.workload} needs {chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}. No result.", file=sys.stderr)
        return 2
    import nemo_tpu_torch
    if not os.path.abspath(nemo_tpu_torch.__file__).startswith(REPO + os.sep):
        print(f"portbench: nemo_tpu_torch came from "
              f"{nemo_tpu_torch.__file__}, outside this checkout. No result.",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    parts["cuda_context"] = time.perf_counter() - t
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", T_START, parts=parts)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}. No result.",
              file=sys.stderr)
        return 3
    for name, value, limit in out["compared"]:
        print(f"compared {name}: {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(_json_safe(out["result"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
