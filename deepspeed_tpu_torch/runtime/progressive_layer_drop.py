"""Progressive Layer Drop (https://arxiv.org/pdf/2010.13369.pdf).

Counterpart of ``deepspeed_tpu/runtime/progressive_layer_drop.py`` (the
reference's ``deepspeed/runtime/progressive_layer_drop.py``): the keep
probability ``theta(t) = (1 - theta) e^(-gamma t) + theta``, updated by the
engine after each step (``DeepSpeedEngine._finish_step``) and reported by
:meth:`ProgressiveLayerDrop.get_state`.  As in the JAX package, no model
of the port reads it.
"""

import numpy as np

from ..utils.logging import log_dist


class ProgressiveLayerDrop:
    def __init__(self, theta=0.5, gamma=0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0
        log_dist(f"Enabled progressive layer dropping (theta = {self.theta})", ranks=[0])

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step):
        self.current_theta = (1.0 - self.theta) * np.exp(-self.gamma * global_step) + self.theta
        return self.current_theta
