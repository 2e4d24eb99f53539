"""Config registry of the port (counterpart of ``repro/configs``).

Only the architectures whose family the port runs resolve; any other id
of the JAX package's zoo raises ``NotImplementedError`` (ROADMAP.md,
queue 1 item 17).
"""
from importlib import import_module

_PORTED = {
    "zamba2-1.2b": "zamba2_1_2b",
}

ARCH_IDS = tuple(_PORTED)


def get_config(arch_id: str):
    if arch_id not in _PORTED:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported to repro_torch yet "
            f"(ported: {', '.join(ARCH_IDS)}; ROADMAP.md queue 1 item 17)")
    return import_module(f"repro_torch.configs.{_PORTED[arch_id]}").CONFIG
