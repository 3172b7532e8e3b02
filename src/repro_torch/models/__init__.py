"""Model zoo of the port: one functional transformer for the ``dense``,
``moe``, ``ssm``, ``hybrid``, ``vlm`` and ``audio`` families (the
reference's public names; the mesh's ``param_specs`` has no meaning on
one card)."""
from .transformer import (decode_step, forward, init_decode_cache,
                          init_params, layer_flags, loss_fn, prefill)

__all__ = ["forward", "loss_fn", "prefill", "decode_step", "init_params",
           "init_decode_cache", "layer_flags"]
