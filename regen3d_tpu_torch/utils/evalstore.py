"""Evaluation persistence: timestamped run dirs + automatic comparison
(counterpart of regen3d_tpu/utils/evalstore.py).

Reference contract (utils/eval_utils.py:22-130): each evaluation writes
output/evaluation/<YY_MM_DD_HHMMSS>/ with metrics.json, metrics.csv, a copy
of the config, and comparison.csv diffing against the previous run.

The GPU machine has no PyYAML, so the config copy is written by
:func:`dump_yaml`, a block-style emitter for the values a config holds
(None, booleans, numbers, strings, lists and nested dicts) that
``yaml.safe_load`` reads back to the same values.
"""

from __future__ import annotations

import csv
import json
import math
import os
import time
from typing import Dict, List, Optional


def _yaml_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        # PyYAML's float representer: YAML 1.1 wants a dot before the
        # exponent (1e-05 would load as a string)
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        s = repr(v).lower()
        if "." not in s and "e" in s:
            s = s.replace("e", ".0e", 1)
        return s
    if isinstance(v, str):
        return json.dumps(v)        # a YAML double-quoted scalar
    raise TypeError(f"dump_yaml: cannot write a {type(v).__name__}")


def _yaml_lines(v, indent: int) -> List[str]:
    pad = " " * indent
    if isinstance(v, dict):
        if not v:
            return [pad + "{}"]
        out = []
        for k in sorted(v):
            item = v[k]
            key = pad + _yaml_scalar(str(k)) + ":"
            if isinstance(item, (dict, list)) and item:
                out.append(key)
                out.extend(_yaml_lines(item, indent + 2))
            else:
                out.append(key + " " + _yaml_lines(item, 0)[0])
        return out
    if isinstance(v, (list, tuple)):
        if not v:
            return [pad + "[]"]
        out = []
        for item in v:
            sub = _yaml_lines(item, indent + 2)
            out.append(pad + "- " + sub[0][indent + 2:])
            out.extend(sub[1:])
        return out
    return [pad + _yaml_scalar(v)]


def dump_yaml(values: dict, path: str) -> None:
    """Write ``values`` as block-style YAML with sorted keys, as
    ``yaml.safe_dump`` would lay it out; strings are double-quoted."""
    with open(path, "w") as f:
        f.write("\n".join(_yaml_lines(dict(values), 0)) + "\n")


def dump_evaluation(eval_root: str, metrics: Dict[str, float],
                    config_values: Optional[dict] = None,
                    timestamp: Optional[str] = None) -> str:
    ts = timestamp or time.strftime("%y_%m_%d_%H%M%S")
    out_dir = os.path.join(eval_root, ts)
    os.makedirs(out_dir, exist_ok=True)

    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2, sort_keys=True)
    with open(os.path.join(out_dir, "metrics.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["metric", "value"])
        for k in sorted(metrics):
            w.writerow([k, metrics[k]])
    if config_values is not None:
        dump_yaml(config_values, os.path.join(out_dir, "config.yaml"))

    prev = get_previous_evaluation(eval_root, exclude=ts)
    if prev is not None:
        compare_metrics_to_csv(prev, metrics,
                               os.path.join(out_dir, "comparison.csv"))
    return out_dir


def get_previous_evaluation(eval_root: str, exclude: Optional[str] = None
                            ) -> Optional[Dict[str, float]]:
    """Most recent earlier run's metrics (eval_utils.py:72-86)."""
    if not os.path.isdir(eval_root):
        return None
    runs = sorted(d for d in os.listdir(eval_root)
                  if os.path.isfile(os.path.join(eval_root, d, "metrics.json"))
                  and d != exclude)
    if not runs:
        return None
    with open(os.path.join(eval_root, runs[-1], "metrics.json")) as f:
        return json.load(f)


def compare_metrics_to_csv(prev: Dict[str, float], cur: Dict[str, float],
                           out_path: str) -> None:
    """metric, previous, current, delta, pct (eval_utils.py:89-130)."""
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["metric", "previous", "current", "delta", "pct_change"])
        for k in sorted(set(prev) | set(cur)):
            p = prev.get(k)
            c = cur.get(k)
            if p is None or c is None or not isinstance(p, (int, float)) \
                    or not isinstance(c, (int, float)):
                w.writerow([k, p, c, "", ""])
                continue
            delta = c - p
            pct = (delta / p * 100.0) if p != 0 else float("inf")
            w.writerow([k, p, c, delta, f"{pct:.2f}"])
