"""What the model axis pays for repeating the attention core on every rank.

    python3 scripts/torch_attention_core_cost.py        # one card

On a model axis the leaf rule cuts attention's head_dim, so each rank of
a model group gathers q/k/v whole and runs the whole core
(``models.layers.attend``).  A head-split core would run a rank's share
of the heads instead.  For each of [mesh-model]'s configurations
(``chip_smoke.MESH_MODEL`` and ``MESH_MODEL_MORE``; xLSTM has no
attention) this times ``attend`` forward and backward
on the card at the per-client shape of a microbatch, bf16, with all the
heads and with the largest share a split over the model axis leaves one
rank (whole KV groups: smollm-360m's 5 groups of 3 heads split 3 / 2),
and multiplies by the core's applications per round on one rank.  Prints
one line per configuration and the card's name and power limit.
"""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as C  # noqa: E402

TURNS, CALLS = 5, 20


def _time_ms(fn):
    """Best of ``TURNS`` turns of the mean over ``CALLS`` calls (CUDA
    events)."""
    import torch
    for _ in range(3):
        fn()
    best = None
    for _ in range(TURNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / CALLS
        best = ms if best is None else min(best, ms)
    return best


def core_ms(cfg, B, S, H, Hkv):
    """``attend`` forward + backward at (B, S, H / Hkv heads, head_dim)."""
    import torch
    from repro_torch.models import layers as L
    gen = torch.Generator("cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=cfg.pdtype).requires_grad_()

    q, k, v = (rand(B, S, H, cfg.head_dim), rand(B, S, Hkv, cfg.head_dim),
               rand(B, S, Hkv, cfg.head_dim))
    g = torch.randn((B, S, H, cfg.head_dim), generator=gen, device="cuda",
                    dtype=cfg.pdtype)
    pos = torch.arange(S, device="cuda").expand(B, S)

    def step():
        o = L.attend(q, k, v, pos, pos, cfg)
        torch.autograd.grad(o, (q, k, v), g)

    return _time_ms(step)


def main():
    from repro_torch.models.hybrid import segment_plan
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for arch, flags, world, data, _ in C.MESH_MODEL + C.MESH_MODEL_MORE:
        args = C._spmd_args(arch, C._mesh_model_flags(flags, world, data))
        cfg = C._spmd_cfg(args)
        if cfg.family == "ssm":                      # xLSTM attends nothing
            continue
        m = world // data
        H, Hkv = cfg.n_heads, cfg.n_kv_heads
        share_kv = -(-Hkv // m)                     # whole KV groups
        share = share_kv * (H // Hkv)
        per_fwd = (segment_plan(cfg)[0] if cfg.family == "hybrid"
                   else cfg.n_layers)
        apps = (per_fwd * args.n_local * args.n_micro
                * (args.data_axis // data))
        whole = core_ms(cfg, args.per_micro, args.seq, H, Hkv)
        split = core_ms(cfg, args.per_micro, args.seq, share, share_kv)
        print(f"[attn-core] {smi}; {arch} model axis {m}: attend fwd+bwd "
              f"at ({args.per_micro}, {args.seq}, {H}/{Hkv}, "
              f"{cfg.head_dim}) {cfg.param_dtype} {whole:.4f} ms, at a "
              f"rank's share {share}/{share_kv} heads {split:.4f} ms; "
              f"{apps} applications per round on a rank: {whole * apps:.2f}"
              f" ms against {split * apps:.2f} ms, at most "
              f"{(whole - split) * apps:.2f} ms a round for a head split "
              f"(its all-to-all not counted)", flush=True)
    print(smi)


if __name__ == "__main__":
    main()
