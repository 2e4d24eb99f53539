"""The REP rule registry for the PyTorch port (port of
``repro/analysis/rules.py``).  Each rule codifies one bug class this
repo has shipped and hand-debugged, with its detector written for
PyTorch code.  Rules are AST-only (no imports of the linted code) so
they run on fixtures and broken trees alike.

REP004 (donated-buffer reuse) is not ported: PyTorch has no
``donate_argnums``, so there is no donated buffer to reuse.

Adding a rule: subclass :class:`Rule`, set ``code``/``title``, implement
``check(file, ctx) -> list[Finding]``, and add it to :data:`RULES`.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.lint import Finding, ProjectContext, SourceFile


class Rule:
    code = "REP000"
    title = ""

    def check(self, file: SourceFile, ctx: ProjectContext) -> list:
        raise NotImplementedError

    def finding(self, file, node, message) -> Finding:
        return Finding(self.code, file.path, node.lineno,
                       getattr(node, "col_offset", 0), message)


def _functions(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _params(fn) -> list:
    a = fn.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    return [n for n in names if n not in ("self", "cls")]


def _names_in(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


# ---------------------------------------------------------------------------
# REP001 — cache-key completeness
# ---------------------------------------------------------------------------

class CacheKeyCompleteness(Rule):
    """A tuple used as a memo/cache key must cover every parameter of the
    caching function.

    History: the reference's first cut of ``dp_path`` left it out of the
    ``cached_cohort_step`` key, so two testbeds differing only in DP
    implementation silently shared one step; the port keeps the same
    cache (``engine/cohort_step.py::cached_cohort_step``).  The rule
    finds ``key = (...)`` tuples used in membership tests / subscripts /
    ``.get`` lookups and reports any function parameter not reachable
    from the tuple (directly, or through one level of local dataflow
    such as ``dp_cfg = replace(dp_cfg, ...)``).
    """

    code = "REP001"
    title = "cache-key tuple omits a function parameter"

    def check(self, file, ctx):
        findings = []
        for fn in _functions(file.tree):
            assigns = {}
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    assigns.setdefault(
                        node.targets[0].id, []).append(node.value)
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Tuple)):
                    continue
                key_name = node.targets[0].id
                if not self._used_as_cache_key(fn, key_name):
                    continue
                covered = _names_in(node.value)
                for name in list(covered):
                    for value in assigns.get(name, []):
                        covered |= _names_in(value)
                missing = [p for p in _params(fn) if p not in covered]
                if missing:
                    findings.append(self.finding(
                        file, node,
                        f"cache key `{key_name}` in `{fn.name}` omits "
                        f"parameter(s) {', '.join(missing)} — every input "
                        "that changes the cached value must be in the key "
                        "(or be derived into it), else two configs share "
                        "one entry"))
        return findings

    @staticmethod
    def _used_as_cache_key(fn, name) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Compare) and any(
                    isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
                operands = [node.left] + list(node.comparators)
                if any(isinstance(o, ast.Name) and o.id == name
                       for o in operands[:-1]):
                    return True
            elif (isinstance(node, ast.Subscript)
                    and isinstance(node.slice, ast.Name)
                    and node.slice.id == name):
                return True
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("get", "setdefault", "pop")
                    and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id == name):
                return True
        return False


# ---------------------------------------------------------------------------
# REP002 — spec-codec completeness
# ---------------------------------------------------------------------------

class SpecCodecCompleteness(Rule):
    """Every config dataclass reachable from the spec types must be
    registered in ``_SPEC_TYPES`` (the port's ``api/spec.py``).

    History: a dataclass nested into ``TestbedConfig``/``EngineConfig``
    but missing from the codec registry makes ``encode`` raise (best
    case) or drop the sub-config (worst case) when a spec round-trips
    through JSON.  The rule walks field annotations/defaults from the
    registered set and reports reachable-but-unregistered dataclasses.
    """

    code = "REP002"
    title = "config dataclass reachable from the spec but not in _SPEC_TYPES"

    def check(self, file, ctx):
        findings = []
        for reg in ctx.spec_registries:
            if reg.path != file.path:
                continue
            registered = set(reg.names)
            reachable, stack = set(), [
                n for n in registered if n in ctx.dataclasses]
            while stack:
                cur = stack.pop()
                if cur in reachable:
                    continue
                reachable.add(cur)
                stack.extend(r for r in ctx.dataclasses[cur].refs
                             if r in ctx.dataclasses)
            for name in sorted(reachable - registered):
                info = ctx.dataclasses[name]
                findings.append(Finding(
                    self.code, file.path, reg.line, 0,
                    f"dataclass `{name}` ({info.path}:{info.line}) is "
                    "reachable from the registered spec types but absent "
                    "from _SPEC_TYPES — encode/decode will fail or drop "
                    "it when the spec round-trips through JSON"))
        return findings


# ---------------------------------------------------------------------------
# REP003 — static divisor in a traced body
# ---------------------------------------------------------------------------

_COUNT_ATTR = re.compile(r"^(n_\w+|num_\w+|batch_size)$")
_CFG_NAME = re.compile(r"(^|_)(cfg|config|fl|dp)$")
_TENSOR_MODULES = ("torch", "F")


class StaticDivisor(Rule):
    """Dividing by a static config count inside a tensor body that has a
    batch-derived dimension available.

    History: the reference's ``fl_step`` local phase divided the
    microbatch-grad mean and the noise stddev by the STATIC
    ``fl.n_micro`` while the actual number of microbatches came from the
    batch shape — correct only when the two agreed.  The same divisions
    exist in the port's ``core/fl_step.py`` and
    ``engine/cohort_step.py``.  The rule flags ``x / cfg.n_*``-shaped
    divisions in functions that compute on tensors (use ``torch.``,
    ``F.`` or ``vmap``) and read a ``.shape`` — the signal that a
    runtime-derived count exists.  Two legitimate uses are exempt: shape
    arithmetic feeding a ``.reshape(...)`` (splitting a static factor out
    of a dimension), and pure config-on-config arithmetic
    (``d_model // cfg.n_heads``: the rule tracks which locals are static
    config values and only fires when a non-static name is divided).
    ``%``-divisibility *checks* against the static count are the correct
    defensive pattern and never flag.
    """

    code = "REP003"
    title = "static config count used as divisor in a traced body"

    def check(self, file, ctx):
        findings = []
        for fn in _functions(file.tree):
            if not self._is_traced_body(fn):
                continue
            cfg_names = self._config_names(fn)
            if not cfg_names:
                continue
            static = self._static_names(fn, cfg_names)
            for node in ast.walk(fn):
                if not (isinstance(node, ast.BinOp) and isinstance(
                        node.op, (ast.Div, ast.FloorDiv))):
                    continue
                r = node.right
                if not (isinstance(r, ast.Attribute)
                        and _COUNT_ATTR.match(r.attr)
                        and isinstance(r.value, ast.Name)
                        and r.value.id in cfg_names):
                    continue
                if all(n in static for n in _names_in(node.left)):
                    continue          # config-on-config arithmetic
                if self._in_reshape(file, node):
                    continue
                findings.append(self.finding(
                    file, node,
                    f"`{fn.name}` divides by static "
                    f"`{r.value.id}.{r.attr}` in a tensor body that "
                    "reads a batch shape — derive the count from the "
                    "actual batch dim (static-vs-runtime mismatch scales "
                    "results silently)"))
        return findings

    @staticmethod
    def _is_traced_body(fn) -> bool:
        uses_torch = reads_shape = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute):
                if node.attr == "shape":
                    reads_shape = True
                if (isinstance(node.value, ast.Name)
                        and node.value.id in _TENSOR_MODULES):
                    uses_torch = True
                if node.attr == "vmap":
                    uses_torch = True
            elif isinstance(node, ast.Name) and node.id == "vmap":
                uses_torch = True
        return uses_torch and reads_shape

    @staticmethod
    def _static_names(fn, cfg_names) -> set:
        """Names that only ever derive from config values: the config
        params themselves plus locals assigned from expressions whose
        every Name is already static (fixpoint over the function's
        assignments).  Everything else — data params, shape reads,
        module globals — is non-static, conservatively."""
        static = set(cfg_names)
        assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
        changed = True
        while changed:
            changed = False
            for a in assigns:
                if not all(n in static for n in _names_in(a.value)):
                    continue
                for t in a.targets:
                    for tn in ast.walk(t):
                        if (isinstance(tn, ast.Name)
                                and tn.id not in static):
                            static.add(tn.id)
                            changed = True
        return static

    @staticmethod
    def _config_names(fn) -> set:
        names = set()
        for p in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
            ann = p.annotation
            ann_cfg = (isinstance(ann, ast.Name)
                       and ann.id.endswith("Config")) or (
                isinstance(ann, ast.Constant)
                and str(ann.value).endswith("Config"))
            if _CFG_NAME.search(p.arg) or ann_cfg:
                names.add(p.arg)
        return names

    @staticmethod
    def _in_reshape(file, node) -> bool:
        for anc in file.ancestors(node):
            if (isinstance(anc, ast.Call)
                    and isinstance(anc.func, ast.Attribute)
                    and anc.func.attr == "reshape"):
                return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return False
        return False


# ---------------------------------------------------------------------------
# REP005 — host sync in an engine hot region
# ---------------------------------------------------------------------------

_REGION_RE = re.compile(
    r"^(run_\w+_engine|submit_\w+|stage_\w+|drain\w*|run_cohort\w*)$")
_HOST_SYNC_ATTRS = ("item", "cpu", "tolist", "numpy")


class HostSyncInHotRegion(Rule):
    """Device->host reads inside the engine's submit/drain regions must go
    through the ``_host_fetch`` / ``_host_fetch_array`` funnel
    (``engine/engine.py``).

    History: the pipelined scheduler's whole win is that the host never
    blocks between eval boundaries; one stray ``.item()`` or
    ``float(...)`` on a device value re-serializes the loop and is
    invisible until someone profiles.  The rule flags raw reads
    (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
    ``np.asarray(...)``, ``float(<call>)``) inside functions named like
    engine hot regions (``run_*_engine``, ``submit_*``, ``stage_*``,
    ``drain*``, ``run_cohort*``).  The funnel itself and a CUDA event's
    ``.synchronize()`` (a scheduling barrier, not a transfer into
    Python: the counterpart of ``jax.block_until_ready``) are the
    sanctioned exceptions.
    """

    code = "REP005"
    title = "raw host sync inside an engine submit/drain region"

    def check(self, file, ctx):
        findings = []
        for fn in _functions(file.tree):
            if not _REGION_RE.match(fn.name):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                msg = self._sync_kind(node)
                if msg:
                    findings.append(self.finding(
                        file, node,
                        f"`{msg}` in hot region `{fn.name}` blocks the "
                        "host on device state — route it through the "
                        "_host_fetch funnel (counted, eval-boundary-"
                        "gated) or move it out of the submit/drain path"))
        return findings

    @staticmethod
    def _sync_kind(node):
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _HOST_SYNC_ATTRS:
                return f"…{'.' + f.attr}()"
            if (f.attr == "asarray" and isinstance(f.value, ast.Name)
                    and f.value.id in ("np", "numpy")):
                return "np.asarray()"
        if (isinstance(f, ast.Name) and f.id == "float" and node.args
                and isinstance(node.args[0], ast.Call)):
            return "float(<device value>)"
        return None


# ---------------------------------------------------------------------------
# REP006 — per-client loop in a store residency hot region
# ---------------------------------------------------------------------------

_STORE_REGION_RE = re.compile(
    r"^_?(prefetch|spill|evict|acquire|materialize)\w*$")


class PerClientLoopInStoreRegion(Rule):
    """Residency-management hot paths must walk cohorts/batches, never
    the whole client population.

    History: the tiered store (the port's ``engine/statestore.py``)
    exists because engine loops that touch all N clients per round put
    an O(N)-per-cohort wall into the 100k-client scale run.  The store's
    prefetch/spill/acquire paths run once per cohort, so a Python loop
    over ``clients`` (or ``self.clients``) inside them reintroduces that
    wall — invisible at the 5-client testbed, fatal at scale.  The rule
    flags ``for``-loop and comprehension iterables that reference a
    ``clients`` name/attribute inside functions named like store
    residency regions (``prefetch*``, ``spill*``, ``evict*``,
    ``acquire*``, ``materialize*``, underscore-prefixed included).  Walk
    the cohort's plans or the prefetch batch, or index one client
    (``clients[cid]``), instead.
    """

    code = "REP006"
    title = "per-client loop inside a store residency region"

    def check(self, file, ctx):
        findings = []
        for fn in _functions(file.tree):
            if not _STORE_REGION_RE.match(fn.name):
                continue
            for node in ast.walk(fn):
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    iters = [node.iter]
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.DictComp, ast.GeneratorExp)):
                    iters = [g.iter for g in node.generators]
                else:
                    continue
                if any(self._mentions_clients(it) for it in iters):
                    findings.append(self.finding(
                        file, node,
                        f"loop over the client population in store region "
                        f"`{fn.name}` — residency paths run per cohort: "
                        "walk the cohort/prefetch batch (or index "
                        "clients[cid]) instead"))
        return findings

    @staticmethod
    def _mentions_clients(node) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and n.id == "clients":
                return True
            if isinstance(n, ast.Attribute) and n.attr == "clients":
                return True
        return False


RULES = {
    r.code: r for r in (
        CacheKeyCompleteness(), SpecCodecCompleteness(), StaticDivisor(),
        HostSyncInHotRegion(), PerClientLoopInStoreRegion())
}

# the reference's rules without a counterpart here, and why
NOT_PORTED = {
    "REP004": "PyTorch has no donate_argnums: no buffer is donated, so "
              "none can be read after donation (the port's arenas are "
              "written in place; audits.audit_donation checks that on a "
              "run)",
}

__all__ = ["RULES", "NOT_PORTED", "Rule", "CacheKeyCompleteness",
           "SpecCodecCompleteness", "StaticDivisor", "HostSyncInHotRegion",
           "PerClientLoopInStoreRegion"]
