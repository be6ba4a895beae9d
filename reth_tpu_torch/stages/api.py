"""Stage trait + pipeline driver.

A copy of the JAX package's ``stages/api.py``. Reference analogue: `Stage` (crates/stages/api/src/stage.rs:241) with
`execute`/`unwind`, and `Pipeline::run_loop` (api/src/pipeline/mod.rs:431)
— runs stages in order to a target, commits after every stage execution,
unwinds in reverse order on reorg/bad block.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..storage.provider import DatabaseProvider, ProviderFactory


class StageError(Exception):
    def __init__(self, message: str, block: int | None = None):
        super().__init__(message)
        self.block = block


@dataclass
class ExecInput:
    target: int          # highest block to process
    checkpoint: int      # last block already processed by this stage

    @property
    def next_block(self) -> int:
        return self.checkpoint + 1

    @property
    def is_done(self) -> bool:
        return self.checkpoint >= self.target


@dataclass
class ExecOutput:
    checkpoint: int
    done: bool = True


@dataclass
class UnwindInput:
    unwind_to: int       # keep blocks <= this
    checkpoint: int


class Stage:
    """One unit of the staged sync; processes a block range then commits."""

    id: str = "?"

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        raise NotImplementedError

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        raise NotImplementedError


class Pipeline:
    """Runs stages in order to a target; per-stage commit; reverse unwind."""

    def __init__(self, factory: ProviderFactory, stages: list[Stage]):
        self.factory = factory
        self.stages = stages
        self.events: list[tuple] = []

    def run(self, target: int) -> None:
        """Run every stage to ``target`` (committing per stage iteration)."""
        for stage in self.stages:
            while True:
                with self.factory.provider_rw() as provider:
                    checkpoint = provider.stage_checkpoint(stage.id)
                    if checkpoint >= target:
                        break
                    out = stage.execute(provider, ExecInput(target, checkpoint))
                    provider.save_stage_checkpoint(stage.id, out.checkpoint)
                    self.events.append(("stage", stage.id, out.checkpoint))
                if out.done:
                    break

    def unwind(self, target: int) -> None:
        """Unwind all stages (reverse order) down to ``target``."""
        for stage in reversed(self.stages):
            with self.factory.provider_rw() as provider:
                checkpoint = provider.stage_checkpoint(stage.id)
                if checkpoint <= target:
                    continue
                stage.unwind(provider, UnwindInput(target, checkpoint))
                provider.save_stage_checkpoint(stage.id, target)
                self.events.append(("unwind", stage.id, target))
