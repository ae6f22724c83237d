from repro_torch.models.transformer import (
    count_params_analytic, decode_step, decoder_layer_refs, forward,
    init_decode_state, init_params, layer_plan, unit_cycle,
)

__all__ = [
    "init_params", "forward", "decode_step", "init_decode_state",
    "count_params_analytic", "layer_plan", "unit_cycle",
    "decoder_layer_refs",
]
