"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
configuration's file is the one `configs` gives (its proof system is
`marlin` unless the file's `proof_system` says `plonk`), the mix is
`zkbench/traffic/<traffic>.json`, and each metric is
`zkbench/metrics/<name>.py`. A cell reports the end-to-end metrics
(`--trace 0`) or the per-layer metrics (`--trace 1`) whose `workloads`
list it, or that have no such list. A configuration's file holds the
keys `load_config` reads (`READ`) and those that only describe it
(`DESCRIBE`); any other key is refused, so a misspelt one cannot load as
its default.
"""

from __future__ import annotations

import hashlib
import importlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

from .traffic import Mix, load_mix

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
PROOF_SYSTEMS = ("marlin", "plonk")
MSM_ENGINES = ("mxu", "pallas")
# the keys `load_config` reads, and those that only describe the deployment
# (`assumed`, the sizes a configuration assumed, is one a later file may add)
READ = {"message_bytes", "mode", "msm_engine", "zk", "srs_seed",
        "proof_system"}
DESCRIBE = {"what", "source", "source_detail", "reduced", "shape",
            "guarantees", "assumed"}


@dataclass(frozen=True)
class Config:
    name: str
    msg_len: int
    mode: str
    msm_engine: str
    zk: bool
    srs_seed: int
    digest: str          # of the configuration's file: names its cache
    proof_system: str = "marlin"


@dataclass(frozen=True)
class Cell:
    name: str
    config: Config
    mix: Mix
    chips: int
    metrics: List[dict]  # the cell's entries of end_to_end or per_layer


def load_config(name: str, path: Path) -> Config:
    raw = Path(path).read_bytes()
    d = json.loads(raw)
    unknown = sorted(set(d) - READ - DESCRIBE)
    if unknown:
        raise ValueError(f"{path}: keys the harness does not read: "
                         f"{unknown}")
    cfg = Config(name=name, msg_len=int(d["message_bytes"]), mode=d["mode"],
                 msm_engine=d["msm_engine"], zk=bool(d["zk"]),
                 srs_seed=int(d["srs_seed"]),
                 digest=hashlib.sha256(raw).hexdigest()[:12],
                 proof_system=d.get("proof_system", "marlin"))
    if cfg.proof_system not in PROOF_SYSTEMS:
        raise ValueError(f"{path}: proof_system must be one of "
                         f"{PROOF_SYSTEMS}")
    if cfg.msm_engine not in MSM_ENGINES:
        raise ValueError(f"{path}: msm_engine must be one of {MSM_ENGINES}")
    if cfg.mode != "ecb" or cfg.msg_len <= 0 or cfg.msg_len % 16:
        raise ValueError(f"{path}: an ECB message of a positive multiple "
                         f"of 16 bytes")
    if not cfg.zk:
        raise ValueError(f"{path}: the configurations prove in zero "
                         f"knowledge")
    if cfg.proof_system == "plonk" and (cfg.msg_len, cfg.msm_engine) != (
            16, "mxu"):
        raise ValueError(f"{path}: AES-Plonk proves one 16-byte block, "
                         f"every commitment on K3 (msm_engine \"mxu\")")
    return cfg


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(name: str, trace: bool, root: Path = ROOT) -> Cell:
    m = load_manifest(root)
    by_name = {w["name"]: w for w in m["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    c = next(c for c in m["configs"] if c["name"] == w["config"])
    metrics = [e for e in m["per_layer" if trace else "end_to_end"]
               if name in e.get("workloads", [name])]
    config = load_config(c["name"], Path(root) / c["file"])
    return Cell(name=name, config=config,
                mix=load_mix(HERE / "traffic" / f"{w['traffic']}.json"),
                chips=int(w["chips"]), metrics=metrics)


def metric_module(name: str):
    """zkbench/metrics/<name>.py: `read(run)` and, where it needs them,
    the spans it asks the tracer for (`SPANS`)."""
    return importlib.import_module(f"zkbench.metrics.{name}")
