"""Curriculum learning scheduler.

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``
(``CurriculumScheduler``, the reference's
``deepspeed/runtime/data_pipeline/curriculum_scheduler.py:8``): a
difficulty (the sequence length, for ``curriculum_type`` "seqlen") as a
function of the global step, pure host arithmetic, the same config schema
and values:

- ``fixed_discrete``: a difficulty list and its ``max_step`` boundaries;
- ``fixed_linear`` / ``fixed_root``: the difficulty grows as
  ``(step / total) ** (1 / root)`` from min to max, snapped down to a
  multiple of ``difficulty_step``.

The engine crops each micro-batch to the current difficulty
(``DeepSpeedEngine._apply_curriculum``); a difficulty never falls back.
"""

import math

from ...utils.logging import logger


class CurriculumScheduler:
    def __init__(self, config):
        self.state = {}
        for key in ("curriculum_type", "min_difficulty", "max_difficulty", "schedule_type"):
            if key not in config:
                raise ValueError(f"Curriculum learning requires the config '{key}'")
        self.state["min_difficulty"] = config["min_difficulty"]
        self.state["max_difficulty"] = config["max_difficulty"]
        self.state["current_difficulty"] = config["min_difficulty"]
        self.state["schedule_type"] = config["schedule_type"]
        self.first_step = True
        sched = config.get("schedule_config", {})
        stype = config["schedule_type"]
        if stype == "fixed_discrete":
            if "difficulty" not in sched or "max_step" not in sched:
                raise ValueError("fixed_discrete schedule requires 'difficulty' and 'max_step'")
            if not sched["max_step"] or len(sched["difficulty"]) != len(sched["max_step"]) + 1:
                raise ValueError("fixed_discrete: one more difficulty than max_step entries, "
                                 "and at least one max_step")
        elif stype in ("fixed_root", "fixed_linear"):
            needed = ("total_curriculum_step", "difficulty_step") + (
                ("root_degree",) if stype == "fixed_root" else ())
            for k in needed:
                if k not in sched:
                    raise ValueError(f"{stype} schedule requires '{k}'")
            if sched["difficulty_step"] % 8 != 0:
                logger.warning("difficulty_step should be a multiple of 8 to keep the "
                               "sequence dimension aligned to the tensor-core tiles.")
        else:
            raise RuntimeError("Unsupported curriculum schedule type")
        self.state["schedule"] = sched

    def get_current_difficulty(self):
        return self.state["current_difficulty"]

    def set_current_difficulty(self, difficulty):
        self.state["current_difficulty"] = difficulty

    def get_state(self):
        return self.state

    def set_state(self, state):
        self.state = state

    def _fixed_discrete(self, global_steps):
        s = self.state["schedule"]
        if global_steps > s["max_step"][-1]:
            return s["difficulty"][-1]
        for i, mx in enumerate(s["max_step"]):
            if global_steps <= mx:
                return s["difficulty"][i]

    def _fixed_root(self, global_steps, root_degree=None):
        s = self.state["schedule"]
        if root_degree is None:
            root_degree = s["root_degree"]
        nd = (float(global_steps) / s["total_curriculum_step"]) ** (1.0 / root_degree)
        nd = math.floor(nd * (self.state["max_difficulty"] - self.state["min_difficulty"])
                        + self.state["min_difficulty"])
        nd -= nd % s["difficulty_step"]
        return min(nd, self.state["max_difficulty"])

    def get_difficulty(self, global_steps):
        stype = self.state["schedule_type"]
        if stype == "fixed_discrete":
            return self._fixed_discrete(global_steps)
        if stype == "fixed_linear":
            return self._fixed_root(global_steps, 1)
        if stype == "fixed_root":
            return self._fixed_root(global_steps)
        raise RuntimeError("Unsupported curriculum schedule type")

    def update_difficulty(self, global_steps):
        if self.state["current_difficulty"] < self.state["max_difficulty"]:
            self.state["current_difficulty"] = self.get_difficulty(global_steps)
        return self.state["current_difficulty"]
