"""Config registry: --arch <id> resolution (counterpart of
``repro/configs``), every architecture of the JAX package's zoo."""
from importlib import import_module

_MODULES = {
    "gemma2-2b": "gemma2_2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "whisper-large-v3": "whisper_large_v3",
    "zamba2-1.2b": "zamba2_1_2b",
    "xlstm-350m": "xlstm_350m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "smollm-360m": "smollm_360m",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "llama3.2-3b": "llama3_2_3b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, long_variant: bool = False):
    mod = import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    if long_variant and hasattr(mod, "CONFIG_LONG"):
        return mod.CONFIG_LONG
    return mod.CONFIG


# long_500k support: SSM/hybrid always; gemma2 via its all-local variant;
# everything else skipped (full attention).
LONG_CONTEXT_ARCHS = ("gemma2-2b", "zamba2-1.2b", "xlstm-350m")
