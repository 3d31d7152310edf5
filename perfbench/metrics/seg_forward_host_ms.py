"""Host ms per micro-batch inside the U-Net's forward (the program's
``unet.forward`` span): the time to issue the forward's device work, which
ends before anything waits for it.  Beside the forward's device ms a
micro-batch, it tells whether the forward is bound by its launches."""
from perfbench import recorder


def read(trace):
    return recorder.mean_ms("unet.forward")
