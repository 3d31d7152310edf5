"""Training: the train step (microbatch accumulation, AdamW) and the loop
with checkpoint/restart and the straggler watchdog."""
from . import train_step, trainer  # noqa: F401
