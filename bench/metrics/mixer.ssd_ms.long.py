"""mixer.ssd_ms.long: see ``mixers.mixer_ms``, the mamba layers."""
from mixers import mixer_ms


def read(win):
    return mixer_ms(win, "mamba")
