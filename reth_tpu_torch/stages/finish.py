"""FinishStage (reference crates/stages/stages/src/stages/finish.rs).

A copy of the JAX package's ``stages/finish.py``.
"""

from __future__ import annotations

from ..storage.provider import DatabaseProvider
from .api import ExecInput, ExecOutput, Stage, UnwindInput


class FinishStage(Stage):
    id = "Finish"

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        return ExecOutput(checkpoint=inp.target)

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        return None
