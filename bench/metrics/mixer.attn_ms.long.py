"""mixer.attn_ms.long: see ``mixers.mixer_ms``, the attention layers."""
from mixers import mixer_ms


def read(win):
    return mixer_ms(win, "attention")
