"""Model zoo of the port: one functional transformer for the ``dense``,
``moe``, ``ssm``, ``hybrid``, ``vlm`` and ``audio`` families (the
reference's public names), its PartitionSpecs (``param_specs``) and a
rank's blocks of its initial parameters (``init_params_block``)."""
from .transformer import (decode_step, forward, init_decode_cache,
                          init_params, init_params_block, layer_flags,
                          loss_fn, loss_terms, param_specs, prefill)

__all__ = ["forward", "loss_fn", "loss_terms", "prefill", "decode_step",
           "init_params", "init_params_block", "init_decode_cache",
           "layer_flags", "param_specs"]
