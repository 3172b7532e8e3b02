"""Model zoo of the port: one functional transformer for the ``dense``
and ``moe`` families (the reference's public names; ``loss_fn`` and the
mesh's ``param_specs`` come with training)."""
from .transformer import (decode_step, forward, init_decode_cache,
                          init_params, layer_flags, prefill)

__all__ = ["forward", "prefill", "decode_step", "init_params",
           "init_decode_cache", "layer_flags"]
