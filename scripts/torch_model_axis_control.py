"""[mesh-model]'s full-width bounds, against a control.

    python3 scripts/torch_model_axis_control.py [ARCH ...]   # one card

Runs ``chip_smoke.py``'s [mesh-model] phase (``phase_device``, then
``phase_mesh_model`` on the configs of ``MESH_MODEL`` named, default all)
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
sys.path[:0] = [str(root), str(root / "src")]
import chip_smoke as C
_, smi = C.phase_device()
C.phase_mesh_model(smi, [c for c in C.MESH_MODEL if c[0] in sys.argv[2:]])
print(smi)
"""


def make_copy():
    """The control's tree: this checkout's smoke and port, one line
    changed (asserted to occur once)."""
    shutil.rmtree(COPY, ignore_errors=True)
    (COPY / "src").mkdir(parents=True)
    shutil.copy2(ROOT / "chip_smoke.py", COPY / "chip_smoke.py")
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = COPY / MUTANT_FILE
    text = path.read_text()
    old, new = MUTATION
    if text.count(old) != 1:
        raise SystemExit(f"the mutation's line occurs {text.count(old)} "
                         f"times in {MUTANT_FILE}")
    path.write_text(text.replace(old, new))


def run(root, archs):
    """[mesh-model] from ``root`` in a fresh process: its exit code and
    its failure message ("" when it passed)."""
    proc = subprocess.run([sys.executable, "-c", CHILD, str(root), *archs],
                          capture_output=True, text=True)
    said = (proc.stdout + proc.stderr).splitlines()
    for line in said:
        if line.startswith("[mesh-model]") and (
                "relative L2 per leaf" in line or "rank 0:" in line):
            print(f"  {line}", flush=True)
    failed = [ln for ln in said if "chip_smoke FAILED" in ln]
    if proc.returncode and not failed:
        failed = said[-5:] or ["no output"]
    return proc.returncode, failed[-1] if failed else ""


def main():
    import chip_smoke as C
    archs = sys.argv[1:] or [c[0] for c in C.MESH_MODEL]
    print(f"[control] the bounds: gradient max <= "
          f"{C.MESH_MODEL_GRAD_RTOL}; update median <= "
          f"{C.MESH_MODEL_UPDATE_MEDIAN}, max <= {C.MESH_MODEL_UPDATE_MAX}; "
          f"{archs}", flush=True)
    make_copy()
    runs = [("checkout", ROOT, archs)] + [
        (f"control {a}", COPY, [a]) for a in archs]
    ok = True
    for tag, root, names in runs:
        print(f"[control] {tag} ({root}):", flush=True)
        rc, failure = run(root, names)
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
