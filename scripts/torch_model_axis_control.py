"""[mesh-model]'s full-width bounds, against a control.

    python3 scripts/torch_model_axis_control.py [ARCH ...]   # one card
    python3 scripts/torch_model_axis_control.py --cards [ARCH ...]  # four

Runs ``chip_smoke.py``'s [mesh-model] phase (``phase_device``, then
``phase_mesh_model`` on the configs of ``MESH_MODEL`` and
``MESH_MODEL_MORE`` named, default all: the second holds the entries
kept out of ``chip_smoke.py`` for its time limit;
with ``--cards``, on those of ``scripts/torch_model_axis_cards.py``'s
``CONFIGS`` that have a W = 1 run, over NCCL, a card per rank, at
``--devices 4 --data-axis 2``)
in a fresh process twice: from this checkout, and from a copy of
``chip_smoke.py`` and ``src/repro_torch`` under
``build/model_axis_control`` whose ``tp_copy`` backward returns each
rank's partial gradient without the all-reduce (the model-parallel
gradient of every replicated activation then misses the other ranks'
terms).  The control runs each configuration in a process of its own,
since the first bound it fails ends the phase.  Prints each run's
readings of the bounds (the f32 gradient's and the bf16 update's
per-leaf distance from W = 1) and how the phase ended.  Exits 0 when the
checkout passes and the control fails each configuration at a bound.
"""
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "model_axis_control"
MUTANT_FILE = "src/repro_torch/launch/collectives.py"
# _Copy.backward: the sum over the model group dropped
MUTATION = ("        return _sum_f32(g, ctx.group), None\n",
            "        return g, None\n")
BOUND = " bound: "

CHILD = """
import os, sys, pathlib
root = pathlib.Path(sys.argv[1])
os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
sys.path[:0] = [str(root), str(root / "src"), str(root / "scripts")]
import chip_smoke as C
_, smi = C.phase_device()
if sys.argv[2] == "cards":
    from torch_model_axis_cards import CONFIGS
    C.phase_mesh_model(smi, [c for c in CONFIGS if c[0] in sys.argv[3:]],
                       backend="nccl")
else:
    C.phase_mesh_model(smi, [c for c in C.MESH_MODEL + C.MESH_MODEL_MORE
                             if c[0] in sys.argv[3:]])
print(smi)
"""


def make_copy():
    """The control's tree: this checkout's smoke and port, one line
    changed (asserted to occur once)."""
    shutil.rmtree(COPY, ignore_errors=True)
    (COPY / "src").mkdir(parents=True)
    shutil.copy2(ROOT / "chip_smoke.py", COPY / "chip_smoke.py")
    (COPY / "scripts").mkdir()
    shutil.copy2(ROOT / "scripts" / "torch_model_axis_cards.py",
                 COPY / "scripts" / "torch_model_axis_cards.py")
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = COPY / MUTANT_FILE
    text = path.read_text()
    old, new = MUTATION
    if text.count(old) != 1:
        raise SystemExit(f"the mutation's line occurs {text.count(old)} "
                         f"times in {MUTANT_FILE}")
    path.write_text(text.replace(old, new))


def run(root, where, archs):
    """[mesh-model] from ``root`` in a fresh process (``where``: "card" or
    "cards"): its exit code and its failure message ("" when it
    passed)."""
    proc = subprocess.run([sys.executable, "-c", CHILD, str(root), where,
                           *archs], capture_output=True, text=True)
    said = (proc.stdout + proc.stderr).splitlines()
    for line in said:
        if line.startswith("[mesh-model]"):
            print(f"  {line}", flush=True)
    failed = [ln for ln in said if "chip_smoke FAILED" in ln]
    if proc.returncode and not failed:
        # no requirement failed: the last lines say what stopped it
        failed = ["; ".join(ln.strip() for ln in said[-12:] if ln.strip())
                  or "no output"]
    return proc.returncode, failed[-1] if failed else ""


def main():
    import chip_smoke as C
    where = "cards" if sys.argv[1:2] == ["--cards"] else "card"
    named = sys.argv[2:] if where == "cards" else sys.argv[1:]
    if where == "cards":
        sys.path.insert(0, str(ROOT / "scripts"))
        from torch_model_axis_cards import CONFIGS, NO_REFERENCE
        # the bounds need the W = 1 run
        CONFIGS = [c for c in CONFIGS if c[0] not in NO_REFERENCE]
    else:
        CONFIGS = C.MESH_MODEL + C.MESH_MODEL_MORE
    archs = named or [c[0] for c in CONFIGS]
    print(f"[control] {where}: the bounds: gradient max <= "
          f"{C.MESH_MODEL_GRAD_RTOL}; update median <= "
          f"{C.MESH_MODEL_UPDATE_MEDIAN}, max <= {C.MESH_MODEL_UPDATE_MAX} "
          f"({C.MESH_MODEL_UPDATE_MAX_OF} for these); {archs}", flush=True)
    make_copy()
    runs = [("checkout", ROOT, archs)] + [
        (f"control {a}", COPY, [a]) for a in archs]
    ok = True
    for tag, root, names in runs:
        print(f"[control] {tag} ({root}):", flush=True)
        rc, failure = run(root, where, names)
        print(f"[control] {tag}: rc {rc}{': ' + failure if failure else ''}",
              flush=True)
        if root == ROOT:
            ok = ok and rc == 0
        else:
            ok = ok and rc != 0 and BOUND in failure
    shutil.rmtree(COPY, ignore_errors=True)
    print(f"[control] {'as required' if ok else 'NOT as required'}: the "
          "checkout passes and the control fails at a bound")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()
