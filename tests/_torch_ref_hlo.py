"""The JAX package's program walk (``repro.analysis.hlo.analyze``) of
given collectives and matrix products, for holding the port's walk
(``repro_torch.analysis.hlo.analyze``) to it: :func:`module` writes the
HLO text of a program that runs them, :func:`reference_walk` walks it."""


def module(ops, g, dots=()):
    """HLO text of an ENTRY computation running ``ops``, ``[(kind,
    in_bytes), ...]`` with ``kind`` one of ``all-gather``, ``all-reduce``
    and ``reduce-scatter``, each on a ``u8[in_bytes]`` input over
    ``replica_groups=[1,g]``, and ``dots``, ``[(m, k, n), ...]``, each an
    f32 (m, k) x (k, n) product."""
    out = {"all-gather": lambda n: g * n, "all-reduce": lambda n: n,
           "reduce-scatter": lambda n: max(1, n // g)}
    params, lines = [], []
    for i, (kind, n) in enumerate(ops):
        params.append(f"p{i}: u8[{n}]")
        lines.append(f"  %p{i} = u8[{n}]{{0}} parameter({i})")
        extra = ("to_apply=%add" if kind != "all-gather"
                 else "dimensions={0}")
        lines.append(f"  %c{i} = u8[{out[kind](n)}]{{0}} {kind}(u8[{n}]{{0}} "
                     f"%p{i}), replica_groups=[1,{g}]<=[{g}], {extra}")
    for j, (m, k, n) in enumerate(dots):
        a, b = len(ops) + 2 * j, len(ops) + 2 * j + 1
        params += [f"q{a}: f32[{m},{k}]", f"q{b}: f32[{k},{n}]"]
        lines += [f"  %q{a} = f32[{m},{k}]{{1,0}} parameter({a})",
                  f"  %q{b} = f32[{k},{n}]{{1,0}} parameter({b})",
                  f"  %d{j} = f32[{m},{n}]{{1,0}} dot(f32[{m},{k}]{{1,0}} "
                  f"%q{a}, f32[{k},{n}]{{1,0}} %q{b}), "
                  "lhs_contracting_dims={1}, rhs_contracting_dims={0}"]
    return "\n".join([
        "HloModule walk", "",
        "%add (x: u8[], y: u8[]) -> u8[] {",
        "  %x = u8[] parameter(0)",
        "  %y = u8[] parameter(1)",
        "  ROOT %s = u8[] add(u8[] %x, u8[] %y)",
        "}", "",
        f"ENTRY %main ({', '.join(params)}) -> u8[] {{",
        *lines,
        "  ROOT %r = u8[] constant(0)",
        "}", ""])


def reference_walk(ops, g, dots=()):
    """``repro.analysis.hlo.analyze`` of :func:`module`."""
    from repro.analysis.hlo import analyze
    return analyze(module(ops, g, dots))
