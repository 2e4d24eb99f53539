"""The JAX package's multi-pod dry run (``repro/launch/dryrun.py``) lowers
and compiles every (architecture x input shape x production mesh)
program with XLA and reads memory, FLOPs and collective bytes from the
compiled artifact.  Its meshes are the 16x16 and 2x16x16 production
meshes, and it lowers the serving programs (prefill, decode) on them,
which the port does not run on a mesh; PyTorch has no ahead-of-time
compiled artifact to read.  Each entry point raises, naming ROADMAP.md
queue 1 item 19 (its third part).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b
"""
from __future__ import annotations

import sys

from repro_torch.launch.mesh import not_ported


def run_one(arch_id: str, shape_name: str, mesh_kind: str, **kw):
    raise not_ported(f"the dry run of {arch_id} x {shape_name} on the "
                     f"{mesh_kind} production mesh")


def main(argv=None):
    raise not_ported("launch/dryrun.py (the production meshes' dry run)")


if __name__ == "__main__":
    sys.exit(main())
