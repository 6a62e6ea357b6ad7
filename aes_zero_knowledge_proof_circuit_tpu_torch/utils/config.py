"""Framework configuration (typed; SURVEY.md §5 "config/flag system").

The reference has no runtime config (message length is the only parameter,
src/lib.rs:138); this package keeps a small typed config: the artifact
cache directory (ZKAES_CACHE_DIR), the default hiding, the mesh axis name.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

_DEF_CACHE = os.environ.get(
    "ZKAES_CACHE_DIR", os.path.join(os.path.expanduser("~"), ".cache", "zkaes-tpu")
)


@dataclass
class Config:
    # directory for compiled circuit templates, SRS checkpoints, keys
    cache_dir: str = _DEF_CACHE
    # default hiding (the reference proves in zero-knowledge)
    zk: bool = True
    # mesh axis name used by parallel/ modules
    mesh_axis: str = "shard"

    @property
    def template_dir(self) -> Path:
        p = Path(self.cache_dir) / "templates"
        p.mkdir(parents=True, exist_ok=True)
        return p

    @property
    def srs_dir(self) -> Path:
        p = Path(self.cache_dir) / "srs"
        p.mkdir(parents=True, exist_ok=True)
        return p


CONFIG = Config()
