"""Weights from the flax Llama, Mixtral and GPT (`ray_tpu.models.llama`,
`ray_tpu.models.mixtral`, `ray_tpu.models.gpt`) to the port.

Takes the flax parameter tree as nested dicts of arrays (anything
`numpy.asarray` reads) and returns a `state_dict` for
`ray_tpu_torch.models.LlamaForCausalLM`, `MixtralForCausalLM` or
`GPTForCausalLM`, in
float32; `load_state_dict` casts to the model's `param_dtype`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    # float32 first: numpy has no bfloat16 that torch reads, and the
    # widening is exact.
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _decoder_params_from_flax(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Embedding, final norm, and each layer's norms and attention."""
    out = {"embed_tokens.weight": _tensor(p["embed_tokens"]["embedding"]),
           "final_norm.scale": _tensor(p["final_norm"]["scale"])}
    for i in range(_num_layers(p)):
        layer, pre = p[f"layers_{i}"], f"layers.{i}."
        for norm in ("input_norm", "post_attn_norm"):
            out[pre + norm + ".scale"] = _tensor(layer[norm]["scale"])
        attn = layer["attn"]
        for name in ("q_proj", "k_proj", "v_proj"):
            kernel = _tensor(attn[name]["kernel"])  # [in, heads, hd]
            out[f"{pre}attn.{name}.weight"] = (
                kernel.reshape(kernel.shape[0], -1).T.contiguous()
            )
        o = _tensor(attn["o_proj"]["kernel"])  # [heads, hd, out]
        out[pre + "attn.o_proj.weight"] = o.reshape(-1, o.shape[-1]).T.contiguous()
    return out


def _num_layers(p: Mapping[str, Any]) -> int:
    return sum(1 for name in p if name.startswith("layers_"))


def llama_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax layouts to torch ones:

    - `embed_tokens/embedding` [V, H] stays [V, H];
    - `{q,k,v}_proj/kernel` [in, heads, hd] becomes [heads * hd, in];
    - `o_proj/kernel` [heads, hd, out] becomes [out, heads * hd];
    - `{gate,up,down}_proj/kernel` [in, out] becomes [out, in];
    - `*_norm/scale` stays as it is;
    - `lm_head/kernel` [H, V] becomes [V, H].
    """
    p = params.get("params", params)
    out = _decoder_params_from_flax(p)
    if "lm_head" in p:
        out["lm_head.weight"] = _tensor(p["lm_head"]["kernel"]).T.contiguous()
    for i in range(_num_layers(p)):
        mlp = p[f"layers_{i}"]["mlp"]
        for name in ("gate_proj", "up_proj", "down_proj"):
            out[f"layers.{i}.mlp.{name}.weight"] = _tensor(mlp[name]["kernel"]).T.contiguous()
    return out


def mixtral_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """As `llama_params_from_flax` for the embedding, norms and attention;
    for each MoE layer:

    - `moe/router/kernel` [H, E] becomes [E, H];
    - `moe/w_gate`, `moe/w_up` [E, H, F] and `moe/w_down` [E, F, H] stay
      as they are (the grouped matmul's rhs layout).

    The head is the embedding (always tied), so there is no `lm_head`.
    """
    p = params.get("params", params)
    out = _decoder_params_from_flax(p)
    for i in range(_num_layers(p)):
        moe, pre = p[f"layers_{i}"]["moe"], f"layers.{i}.moe."
        out[pre + "router.weight"] = _tensor(moe["router"]["kernel"]).T.contiguous()
        for name in ("w_gate", "w_up", "w_down"):
            out[pre + name] = _tensor(moe[name])
    return out


def gpt_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax GPT layouts (`ray_tpu.models.gpt`) to the port's
    (`ray_tpu_torch.models.GPTForCausalLM`):

    - `wte/embedding` [V, H] and `wpe/embedding` [max_seq_len, H] stay;
    - `h_{i}/c_attn/kernel` [H, 3, heads, hd] becomes [3 * heads * hd, H]
      and its bias [3, heads, hd] becomes [3 * heads * hd], so the output
      splits as (3, heads, hd) in the reference's order;
    - `h_{i}/c_proj/kernel` [heads, hd, H] becomes [H, heads * hd];
    - `h_{i}/c_fc/kernel` and `h_{i}/c_proj_mlp/kernel` [in, out] become
      [out, in]; every other bias stays;
    - `ln_1`, `ln_2`, `ln_f` `scale` and `bias` stay.
    """
    p = params.get("params", params)
    out = {"wte.weight": _tensor(p["wte"]["embedding"]),
           "wpe.weight": _tensor(p["wpe"]["embedding"])}
    for norm in ("scale", "bias"):
        out[f"ln_f.{norm}"] = _tensor(p["ln_f"][norm])
    n_layers = sum(1 for name in p if name.startswith("h_"))
    for i in range(n_layers):
        block, pre = p[f"h_{i}"], f"h.{i}."
        for name in ("ln_1", "ln_2"):
            for norm in ("scale", "bias"):
                out[f"{pre}{name}.{norm}"] = _tensor(block[name][norm])
        for name in ("c_attn", "c_fc", "c_proj_mlp"):
            kernel = _tensor(block[name]["kernel"])  # [in, ...out]
            out[f"{pre}{name}.weight"] = kernel.reshape(kernel.shape[0], -1).T.contiguous()
            out[f"{pre}{name}.bias"] = _tensor(block[name]["bias"]).reshape(-1)
        kernel = _tensor(block["c_proj"]["kernel"])  # [heads, hd, out]
        out[pre + "c_proj.weight"] = kernel.reshape(-1, kernel.shape[-1]).T.contiguous()
        out[pre + "c_proj.bias"] = _tensor(block["c_proj"]["bias"])
    return out
