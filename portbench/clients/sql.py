"""The SQL client: loads the configuration's tables as frames, renders a
workload's templates with each execution's parameters and runs them
through ``repro_torch.sql.execute`` under the workload's
``CONFIG.compiled`` mode.  A result is the frame's columns on the host
(``to_dict``).  ``stats`` holds what the readers take from set-up:
``load_s``, the seconds to load every table."""
from __future__ import annotations

import tomllib
from pathlib import Path

from portbench import traffic
from portbench.clients import load

QUERIES = Path(__file__).resolve().parents[1] / "queries"


class Client:
    def __init__(self, workload: dict, tables: dict, device: str):
        from repro_torch import sql
        from repro_torch.core.config import CONFIG

        with open(QUERIES / workload["templates"], "rb") as f:
            self.templates = tomllib.load(f)
        self.frames, load_s = load.frames(tables, device)
        self.stats = {"load_s": load_s}
        CONFIG.compiled = workload["compiled"]
        self._execute = sql.execute

    def run(self, name: str, params: dict) -> dict:
        text = traffic.render_sql(self.templates[name]["sql"], params)
        return self._execute(text, self.frames).to_dict()
