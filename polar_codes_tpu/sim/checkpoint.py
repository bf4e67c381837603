"""Checkpoint/resume for long Monte-Carlo sweeps.

The reference has none (jobs are short, results written once at the end —
SURVEY.md section 5); for accelerator-scale sweeps that run for hours across
preemptible capacity this adds the missing durability: after every chunk
the accumulated counters are written to a .npz next to the output CSV, and
a restarted sweep resumes at the first unfinished (job, chunk) pair with
identical PRNG streams (fold_in is deterministic in (key, chunk index)).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np


class SweepCheckpoint:
    """Counter state for a list of (job-id -> accumulated stats)."""

    def __init__(self, path: str):
        self.path = path
        self.state: Dict[str, dict] = {}
        if os.path.exists(path):
            with np.load(path, allow_pickle=False) as z:
                blob = bytes(z["state"].tobytes())
            self.state = json.loads(blob.decode())

    def job_state(self, job_id: str) -> dict:
        return self.state.get(
            job_id,
            {"chunks_done": 0, "runs": 0, "biterrors": 0, "errors": 0,
             "reported": 0, "times": []},
        )

    def update(self, job_id: str, state: dict):
        self.state[job_id] = state
        self._write()

    def mark_complete(self, job_id: str, result: dict):
        st = self.job_state(job_id)
        st["complete"] = True
        st["result"] = result
        self.state[job_id] = st
        self._write()

    def completed(self, job_id: str) -> Optional[dict]:
        st = self.state.get(job_id)
        if st and st.get("complete"):
            return st["result"]
        return None

    def _write(self):
        blob = np.frombuffer(
            json.dumps(self.state).encode(), dtype=np.uint8
        )
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(self.path)) or "."
        )
        os.close(fd)
        np.savez(tmp, state=blob)
        os.replace(tmp + ".npz", self.path)
        if os.path.exists(tmp):
            os.remove(tmp)
