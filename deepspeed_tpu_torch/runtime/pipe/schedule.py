"""Pipeline instruction schedules.

The port's own copy of ``deepspeed_tpu/runtime/pipe/schedule.py`` (reference
``runtime/pipe/schedule.py``: ``TrainSchedule``:182 1F1B,
``InferenceSchedule``:129, the instruction vocabulary :317-476), the same
streams tick for tick. Pure-Python generators; 1F1B runs
2*(micro_batches + stages - 1) ticks with min(stages - stage_id + 1,
micro_batches) buffers (reference :243-289)."""

from __future__ import annotations

from typing import Iterator, List


class PipeInstruction:
    def __init__(self, **kwargs):
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        args = ", ".join(f"{k}={v}" for k, v in self.kwargs.items())
        return f"{type(self).__name__}({args})"

    def __eq__(self, other):
        return type(self) is type(other) and self.kwargs == other.kwargs


class OptimizerStep(PipeInstruction): pass
class ReduceGrads(PipeInstruction): pass
class ReduceTiedGrads(PipeInstruction): pass
class LoadMicroBatch(PipeInstruction): pass
class ForwardPass(PipeInstruction): pass
class BackwardPass(PipeInstruction): pass
class SendActivation(PipeInstruction): pass
class RecvActivation(PipeInstruction): pass
class SendGrad(PipeInstruction): pass
class RecvGrad(PipeInstruction): pass


class PipeSchedule:
    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    @property
    def num_pipe_buffers(self):
        return self.micro_batches

    def steps(self) -> Iterator[List[PipeInstruction]]:
        raise NotImplementedError

    def __iter__(self):
        return self.steps()


class InferenceSchedule(PipeSchedule):
    """Forward-only pipelining."""

    def steps(self):
        total = self.micro_batches + self.stages - 1
        for step_id in range(total):
            micro = step_id - self.stage_id
            cmds: List[PipeInstruction] = []
            if 0 <= micro < self.micro_batches:
                buf = micro % self.num_pipe_buffers
                if self.is_first_stage or self.is_last_stage:
                    cmds.append(LoadMicroBatch(buffer_id=buf))
                if not self.is_first_stage:
                    cmds.append(RecvActivation(buffer_id=buf))
                cmds.append(ForwardPass(buffer_id=buf))
                if not self.is_last_stage:
                    cmds.append(SendActivation(buffer_id=buf))
            yield cmds

    @property
    def num_pipe_buffers(self):
        return 2


class TrainSchedule(PipeSchedule):
    """1F1B interleave. Even ticks run forwards, odd ticks backwards; steady
    state alternates 1 forward / 1 backward per stage; total ticks
    2*(M + S - 1)."""

    @property
    def num_pipe_buffers(self):
        return max(2, min(self.stages - self.stage_id + 1, self.micro_batches))

    def _step_to_micro(self, step_id: int):
        """Map a tick to (micro_batch_id, is_forward). Mirrors the reference's
        even/odd decoding (schedule.py:249-289)."""
        is_forward = step_id % 2 == 0
        base = step_id // 2
        if is_forward:
            micro = base - self.stage_id // 2
        else:
            micro = base - (self.stages - self.stage_id - 1 + 1) // 2
        return micro, is_forward

    def steps(self):
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        prev_micro_f = -1
        prev_micro_b = -1
        for step_id in range(total_steps):
            micro, is_forward = self._decode(step_id)
            cmds: List[PipeInstruction] = []
            if micro is not None:
                buf = micro % self.num_pipe_buffers
                if is_forward:
                    if self.is_first_stage or self.is_last_stage:
                        cmds.append(LoadMicroBatch(buffer_id=buf))
                    if not self.is_first_stage:
                        cmds.append(RecvActivation(buffer_id=buf))
                    cmds.append(ForwardPass(buffer_id=buf))
                    if not self.is_last_stage:
                        cmds.append(SendActivation(buffer_id=buf))
                else:
                    if not self.is_last_stage:
                        cmds.append(RecvGrad(buffer_id=buf))
                    cmds.append(BackwardPass(buffer_id=buf))
                    if not self.is_first_stage:
                        cmds.append(SendGrad(buffer_id=buf))
            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())
            yield cmds

    def _decode(self, step_id: int):
        """(micro_id | None, is_forward) for this stage at this tick.

        Forward f of micro m happens at tick  2m + stage        (warmup spacing)
        Backward of micro m happens at tick   2m + 2*stages - 1 - stage
        (so last stage does B immediately after F; earlier stages wait).
        """
        s, S = self.stage_id, self.stages
        # forward?
        if (step_id - s) >= 0 and (step_id - s) % 2 == 0:
            m = (step_id - s) // 2
            if m < self.micro_batches:
                return m, True
        back_off = 2 * S - 1 - s
        if (step_id - back_off) >= 0 and (step_id - back_off) % 2 == 0:
            m = (step_id - back_off) // 2
            if m < self.micro_batches:
                return m, False
        return None, True


class DataParallelSchedule(PipeSchedule):
    """Degenerate single-stage schedule (reference schedule.py:477-503)."""

    def steps(self):
        for micro in range(self.micro_batches):
            cmds = [LoadMicroBatch(buffer_id=0), ForwardPass(buffer_id=0),
                    BackwardPass(buffer_id=0)]
            if micro == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    @property
    def num_pipe_buffers(self):
        return 1
