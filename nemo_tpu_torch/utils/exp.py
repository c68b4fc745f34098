"""Run directories, timers and the JSONL metric log (port of
nemo_tpu/utils/exp.py and the config merge of nemo_tpu/utils/config.py)."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import os.path as osp
import sys
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional


class Timer:
    """Wall-clock section timer."""

    def __init__(self, name: str, quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self.duration: Optional[float] = None

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.duration = time.time() - self.t0
        if not self.quiet:
            print(f"[timer] {self.name}: {self.duration:.2f}s")


def create_latest_child_dir(exp_dir: str) -> str:
    """Auto-incrementing run directory exp_dir/000NNN."""
    os.makedirs(exp_dir, exist_ok=True)
    existing = [int(d) for d in os.listdir(exp_dir) if d.isdigit()]
    child = osp.join(exp_dir, f"{(max(existing) + 1) if existing else 0:06d}")
    os.makedirs(child, exist_ok=True)
    return child


class MetricWriter:
    """Append-only JSONL metric log (one record per phase or chunk)."""

    def __init__(self, path: str):
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        self._f = open(path, "a")

    def write(self, record: Dict[str, Any]) -> None:
        record = {k: (float(v) if hasattr(v, "item") else v)
                  for k, v in record.items()}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def explicit_cli_keys(argv: Optional[List[str]] = None) -> List[str]:
    argv = sys.argv[1:] if argv is None else argv
    return [a[2:].split("=")[0] for a in argv if a.startswith("--")]


def merge_config(parser: argparse.ArgumentParser,
                 argv: Optional[List[str]] = None) -> SimpleNamespace:
    """defaults <- YAML(--default_config) <- explicitly passed CLI flags
    (reference exp_utils.py:60-81)."""
    args = parser.parse_args(argv)
    passed = explicit_cli_keys(argv)
    cfg = vars(parser.parse_args([]))
    if getattr(args, "default_config", ""):
        import yaml
        with open(args.default_config) as f:
            cfg.update(yaml.safe_load(f) or {})
    for k in vars(args):
        if k in passed:
            cfg[k] = getattr(args, k)
    return SimpleNamespace(**cfg)


def dataclass_from_namespace(cls, ns) -> Any:
    """Populate a dataclass from a namespace, ignoring unknown fields."""
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(ns).items() if k in fields})
