"""Run one cell again and again, each run a process of its own, and keep
every run's result line: the sets that BENCHMARK.json's bounds are set
from, and any other series of runs.

    python3 portbench/tools/sets.py --workload <cell> --seeds 1,2,3 \
        --sets 2 --seconds 10 [--trace 0] [--prefix "taskset -c 2"] \
        [--out out/sets_<cell>.jsonl]

Each seed runs once a set, in the order given; with several prefixes
each seed runs once under each, in turn. A line of the output holds the
set, the seed, the prefix, the exit code, the run's result line, its
set-up parts and window marks from standard error, and the host's CPU
time over the run from /proc/stat (steal included). The card's name and
power limit open the file.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def cpu_jiffies() -> list:
    """The 'cpu' line of /proc/stat: user, nice, system, idle, iowait,
    irq, softirq, steal."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except OSError:
        return []


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not found"


def one_run(args, seed: int, prefix: str) -> dict:
    cmd = shlex.split(prefix) + [
        sys.executable, "portbench/run.py", "--workload", args.workload,
        "--seed", str(seed), "--seconds", str(args.seconds),
        "--trace", str(args.trace)]
    j0, t0 = cpu_jiffies(), time.perf_counter()
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=args.seconds + 1200)
    j1 = cpu_jiffies()
    lines = p.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        line = None
    err = p.stderr.splitlines()
    keep = [s[:2000] for s in err if s.startswith(("setup parts",
                                                    "window marks"))]
    out = {"seed": seed, "prefix": prefix, "rc": p.returncode,
           "process_s": time.perf_counter() - t0, "line": line,
           "stderr": keep}
    if j0 and j1:
        d = [b - a for a, b in zip(j0, j1)]
        out["cpu_jiffies"] = dict(zip(("user", "nice", "system", "idle",
                                       "iowait", "irq", "softirq", "steal"),
                                      d))
    if p.returncode != 0 or line is None:
        out["stderr_tail"] = p.stderr[-3000:]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--prefix", action="append", default=None,
                    help="a command to run run.py under; may repeat")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    prefixes = args.prefix or [""]
    out = args.out or os.path.join(REPO, "out",
                                   f"sets_{args.workload}.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "a") as f:
        f.write(json.dumps({"smi": smi(), "argv": sys.argv[1:]}) + "\n")
        for s in range(args.sets):
            for seed in seeds:
                for prefix in prefixes:
                    row = {"set": s, **one_run(args, seed, prefix)}
                    f.write(json.dumps(row) + "\n")
                    f.flush()
                    m = (row["line"] or {}).get("metrics", {})
                    print(json.dumps({"set": s, "seed": seed,
                                      "prefix": prefix, "rc": row["rc"],
                                      "correct": (row["line"] or {})
                                      .get("correct"),
                                      **{k: v["value"]
                                         for k, v in m.items()}}),
                          flush=True)
        f.write(json.dumps({"smi": smi()}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
