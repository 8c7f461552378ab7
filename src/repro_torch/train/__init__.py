"""Training: AdamW, the train step, the synthetic corpus and checkpoints —
the port of ``repro.train``."""
from repro_torch.train.optimizer import adamw_init, adamw_init_spec, adamw_update
from repro_torch.train.step import cross_entropy, make_train_step

__all__ = [
    "adamw_init_spec",
    "adamw_init",
    "adamw_update",
    "make_train_step",
    "cross_entropy",
]
