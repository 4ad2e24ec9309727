"""Training and serving steps of the LM side (``repro.train``): AdamW,
the train step factory, and the prefill / decode step factories."""

from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.serve_step import make_decode_step, make_prefill
from repro_torch.train.train_step import (
    TrainConfig,
    TrainState,
    abstract_train_state,
    init_ef_state,
    init_train_state,
    make_train_step,
    resolve_pods,
    state_axes,
)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update",
    "TrainConfig", "TrainState", "make_train_step", "init_train_state",
    "abstract_train_state", "init_ef_state", "resolve_pods", "state_axes",
    "make_prefill", "make_decode_step",
]
