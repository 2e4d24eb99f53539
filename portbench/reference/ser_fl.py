"""Plain reference of one FedAsync run of the paper's testbed: the SER CNN
(paper Sec. 3.1), per-example DP-SGD (Eq. 4-6: clip each example's
gradient to C, average, add N(0, (sigma C / B)^2)), each client's Adam,
the staleness-weighted merge g <- (1 - w) g + w p with w = alpha / (1 +
tau) (Eq. 10-11), merged one member after another, the moments
accountant's epsilon (Eq. 7-8) and the event loop over the tier clocks.

Plain PyTorch and numpy, one client at a time, one merge at a time; it
imports nothing of the program.  What it shares with the program is the
definition of the inputs, worked out again from the same seeds: the
corpus (``ser_data.py``), the initial weights (uniform +-1/sqrt(fan_in)
from a CPU ``torch.Generator``), the tier clocks, the dispatch seeds
(``np.random.default_rng(seed).integers(0, 2**62)``: N at start, then one
per re-dispatch) and each dispatch's noise (a device ``torch.Generator``
seeded with its dispatch seed, one draw of D standard normals per local
step, laid out in sorted-key leaf order).

Cohorts: the completions within ``staleness_window`` virtual seconds of
the earliest, at most ``max_cohort``, cut to a power of two, leave the
event heap together; each member trains from the globals it pulled at
dispatch; a member's staleness counts the merges before it.
"""
from __future__ import annotations

import heapq
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad, vmap

from portbench.reference.ser_data import client_splits

SEED_HIGH = 2 ** 62
# the five hardware tiers (mean compute s, lognormal sigma, exchange s,
# dropout probability per round, dropout penalty s): paper Table 1/2
TIERS = (
    (540.0, 0.22, 0.175, 0.05, 180.0),
    (470.0, 0.20, 0.16, 0.033, 150.0),
    (230.0, 0.12, 0.09, 0.0, 0.0),
    (72.0, 0.06, 0.027, 0.0, 0.0),
    (66.0, 0.05, 0.025, 0.0, 0.0),
)
TIER_NAMES = ("HW_T1", "HW_T2", "HW_T3", "HW_T4", "HW_T5")
ORDERS = tuple(range(1, 65)) + (80, 96, 128, 192, 256, 512)


# -- the model ---------------------------------------------------------------

def init_params(seed: int, m: dict) -> dict:
    """Uniform(+-1/sqrt(fan_in)) weights, zero biases, unit GroupNorm
    scales, drawn in this order from a CPU generator seeded with ``seed``:
    conv1.w, conv2.w, fc1.w, out.w."""
    gen = torch.Generator("cpu").manual_seed(int(seed))

    def uniform(shape, fan_in):
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return (u * 2.0 - 1.0) * (1.0 / fan_in ** 0.5)

    k, c0, c1, c2 = m["kernel"], m["n_mels"], m["channels1"], m["channels2"]
    t4 = m["time_frames"] // 4
    conv1 = uniform((k, c0, c1), c0 * k)
    conv2 = uniform((k, c1, c2), c1 * k)
    fc1 = uniform((t4 * c2, m["fc_dim"]), t4 * c2)
    out = uniform((m["fc_dim"], m["num_classes"]), m["fc_dim"])
    return {
        "conv1": {"w": conv1, "b": torch.zeros(c1)},
        "gn1": {"scale": torch.ones(c1), "bias": torch.zeros(c1)},
        "conv2": {"w": conv2, "b": torch.zeros(c2)},
        "gn2": {"scale": torch.ones(c2), "bias": torch.zeros(c2)},
        "fc1": {"w": fc1, "b": torch.zeros(m["fc_dim"])},
        "out": {"w": out, "b": torch.zeros(m["num_classes"])},
    }


def leaf_paths(params) -> list:
    """(module, name) pairs in sorted-key order: the flat layout of D."""
    return [(a, b) for a in sorted(params) for b in sorted(params[a])]


def forward(params, x, groups: int):
    """x (N, T, M) -> logits (N, classes): conv(5, same) -> GroupNorm ->
    ReLU -> max-pool 2, twice, then FC + ReLU and the output layer."""
    h = x
    for conv, gn in (("conv1", "gn1"), ("conv2", "gn2")):
        w = params[conv]["w"]                       # (K, Cin, Cout)
        h = F.conv1d(h.transpose(1, 2), w.permute(2, 1, 0),
                     params[conv]["b"], padding=w.shape[0] // 2)
        h = h.transpose(1, 2)                       # (N, T, C)
        n, t, c = h.shape
        hg = h.reshape(n, t, groups, c // groups)
        mean = hg.mean(dim=(1, 3), keepdim=True)
        var = ((hg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
        h = ((hg - mean) / torch.sqrt(var + 1e-5)).reshape(n, t, c)
        h = F.relu(h * params[gn]["scale"] + params[gn]["bias"])
        h = h.reshape(n, t // 2, 2, c).max(dim=2).values
    h = F.relu(h.reshape(h.shape[0], -1) @ params["fc1"]["w"]
               + params["fc1"]["b"])
    return h @ params["out"]["w"] + params["out"]["b"]


def example_loss(params, x, y, groups):
    logp = torch.log_softmax(forward(params, x[None], groups)[0], dim=-1)
    return -logp.gather(0, y.reshape(1)).squeeze(0)


def accuracy(params, data, groups, device, batch=512) -> float:
    x = torch.as_tensor(data["x"], device=device)
    y = torch.as_tensor(data["y"], device=device).long()
    correct = 0
    with torch.no_grad():
        for i in range(0, x.shape[0], batch):
            pred = forward(params, x[i:i + batch], groups).argmax(-1)
            correct += int((pred == y[i:i + batch]).sum())
    return correct / x.shape[0]


# -- privacy accounting ----------------------------------------------------

def log_moment(q: float, sigma: float, lam: int) -> float:
    """One step's lambda-th log moment of the subsampled Gaussian."""
    alpha = lam + 1
    terms = [math.lgamma(alpha + 1) - math.lgamma(k + 1)
             - math.lgamma(alpha - k + 1) + (alpha - k) * math.log1p(-q)
             + k * math.log(q) + k * (k - 1) / (2.0 * sigma * sigma)
             for k in range(alpha + 1)]
    top = max(terms)
    return top + math.log(sum(math.exp(t - top) for t in terms))


def epsilon(q, sigma, steps, delta) -> float:
    if steps == 0:
        return 0.0
    return min((steps * log_moment(q, sigma, lam) - math.log(delta)) / lam
               for lam in ORDERS)


# -- the run -----------------------------------------------------------------

class _Client:
    def __init__(self, cid, seed, train, test, batch):
        self.cid = cid
        self.tier = TIER_NAMES[cid % 5]
        self.profile = TIERS[cid % 5]
        self.clock = np.random.default_rng(seed * 977 + cid)
        self.rng = np.random.default_rng(seed * 131 + cid)
        self.train, self.test = train, test
        self.n = int(train["y"].shape[0])
        self.steps = (self.n - batch) // batch + 1 if self.n >= batch else 0
        self.opt = None
        self.rounds = 0
        self.rows = None

    def device_rows(self, device):
        if self.rows is None:
            self.rows = (torch.as_tensor(self.train["x"], device=device),
                         torch.as_tensor(self.train["y"],
                                         device=device).long())
        return self.rows

    def duration(self) -> float:
        mean, jitter, exch, p_drop, penalty = self.profile
        t = mean * float(self.clock.lognormal(mean=0.0, sigma=jitter))
        t += exch
        if p_drop > 0 and self.clock.random() < p_drop:
            t += penalty
        return t


def _stack(trees):
    return {a: {b: torch.stack([t[a][b] for t in trees]) for b in sub}
            for a, sub in trees[0].items()}


def _cohort_round(members, setting, sigma, groups, device):
    """One local round (E = 1 epoch of per-example DP-SGD) of each member
    ``(client, params pulled at dispatch, dispatch seed)``, the members
    side by side: their params, batches, noise and Adam states stacked
    on a leading member axis.  Each client's Adam state carries over its
    rounds.  Returns the members' trained params, stacked."""
    B, C, lr = setting["batch_size"], setting["clip_norm"], setting["lr"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    K = len(members)
    params = _stack([p for _, p, _ in members])
    paths = leaf_paths(params)
    for c, p, _ in members:
        if c.opt is None:
            c.opt = {"step": 0,
                     "mu": {a: {b: torch.zeros_like(v) for b, v in sub.items()}
                            for a, sub in p.items()},
                     "nu": {a: {b: torch.zeros_like(v) for b, v in sub.items()}
                            for a, sub in p.items()}}
    mu = _stack([c.opt["mu"] for c, _, _ in members])
    nu = _stack([c.opt["nu"] for c, _, _ in members])
    steps = torch.tensor([float(c.opt["step"]) for c, _, _ in members],
                         dtype=torch.float64, device=device)
    perms = [c.rng.permutation(c.n) for c, _, _ in members]
    gens = [torch.Generator(device).manual_seed(int(s)) for _, _, s in members]
    rows = [c.device_rows(device) for c, _, _ in members]
    d = sum(params[a][b][0].numel() for a, b in paths)
    per_example = vmap(vmap(grad(example_loss), in_dims=(None, 0, 0, None)),
                       in_dims=(0, 0, 0, None))
    n_steps = {c.steps for c, _, _ in members}
    if len(n_steps) != 1:
        raise ValueError(f"members differ in local steps: {n_steps}")
    for s in range(n_steps.pop()):
        idx = [torch.as_tensor(pm[s * B:(s + 1) * B], device=device)
               for pm in perms]
        x = torch.stack([r[0][i] for r, i in zip(rows, idx)])
        y = torch.stack([r[1][i] for r, i in zip(rows, idx)])
        g = per_example(params, x, y, groups)
        flat = torch.cat([g[a][b].reshape(K, B, -1) for a, b in paths], -1)
        scale = 1.0 / torch.clamp(flat.norm(dim=-1) / C, min=1.0)
        z = torch.stack([torch.randn(d, generator=gen, dtype=torch.float32,
                                     device=device) for gen in gens])
        mean = (flat * scale[..., None]).mean(dim=1) + (sigma * C / B) * z
        steps = steps + 1
        bc1 = (1 - b1 ** steps).float()[:, None]
        bc2 = (1 - b2 ** steps).float()[:, None]
        off = 0
        for a, b in paths:
            shape = params[a][b].shape
            n = params[a][b][0].numel()
            gr = mean[:, off:off + n]
            off += n
            m_ = b1 * mu[a][b].reshape(K, n) + (1 - b1) * gr
            v_ = b2 * nu[a][b].reshape(K, n) + (1 - b2) * gr * gr
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            params[a][b] = params[a][b] - lr * upd.reshape(shape)
            mu[a][b], nu[a][b] = m_.reshape(shape), v_.reshape(shape)
    for k, (c, _, _) in enumerate(members):
        c.opt = {"step": c.opt["step"] + c.steps,
                 "mu": {a: {b: v[k] for b, v in sub.items()}
                        for a, sub in mu.items()},
                 "nu": {a: {b: v[k] for b, v in sub.items()}
                        for a, sub in nu.items()}}
    return params


def _pop_cohort(heap, window, max_size):
    events = [heapq.heappop(heap)]
    t0 = events[0][0]
    while heap and len(events) < max_size and heap[0][0] <= t0 + window:
        events.append(heapq.heappop(heap))
    events.sort()
    keep = 1 << (len(events).bit_length() - 1)
    for ev in events[keep:]:
        heapq.heappush(heap, ev)
    return events[:keep]


def run_fedasync(config: dict, traffic: dict, seed: int, sigma: float,
                 device, splits=None):
    """One point of the sweep.  Returns ``(params, log, params0)``; the log
    holds the RunLog's bookkeeping under the same names.  ``splits``: the
    corpus from :func:`ser_data.client_splits`, made here when None."""
    m, setting = config["model"], config["setting"]
    eng = traffic["engine"]
    n_clients = traffic["num_clients"]
    if splits is None:
        splits = client_splits(config["data"], traffic["n_total"],
                               n_clients, seed)
    splits, pooled = splits
    groups = m["gn_groups"]
    alpha = traffic["alpha"]
    delta = eng.get("delta", 1e-5)
    clients = [_Client(c, seed, tr, te, setting["batch_size"])
               for c, (tr, te) in enumerate(splits)]
    params0 = {a: {b: v.to(device) for b, v in sub.items()}
               for a, sub in init_params(seed, m).items()}
    g = params0
    rng = np.random.default_rng(seed)
    log = {"cohort_sizes": [], "times": [], "server_version": [],
           "global_acc": [],
           "update_counts": {t: 0 for t in TIER_NAMES[:min(5, n_clients)]},
           "staleness": {t: [] for t in TIER_NAMES[:min(5, n_clients)]},
           "eps_trajectory": {t: [] for t in TIER_NAMES[:min(5, n_clients)]},
           "local_acc": {}}
    pending, heap = {}, []
    version = 0

    def dispatch(c, s, params):
        c.rounds += 1
        q = min(1.0, setting["batch_size"] / c.n)
        plan = {"params": params, "seed": int(s), "version": version,
                "duration": c.duration(),
                "eps": epsilon(q, sigma, c.rounds * c.steps, delta)
                if sigma > 0 else 0.0}
        pending[c.cid] = plan
        return plan

    for c, s in zip(clients, rng.integers(0, SEED_HIGH, size=n_clients)):
        heap.append((dispatch(c, s, g)["duration"], c.cid))
    heapq.heapify(heap)
    total = 0
    while heap:
        events = _pop_cohort(heap, eng["staleness_window"],
                             eng["max_cohort"])
        plans = []
        for t, cid in events:
            p = pending.pop(cid)
            p["t"] = t
            plans.append((clients[cid], p))
        stacked = _cohort_round([(c, p["params"], p["seed"])
                                 for c, p in plans], setting, sigma, groups,
                                device)
        trained = [{a: {b: v[k] for b, v in sub.items()}
                    for a, sub in stacked.items()} for k in range(len(plans))]
        log["cohort_sizes"].append(len(plans))
        for (c, p), new in zip(plans, trained):
            tau = version - p["version"]
            w = alpha / (1.0 + tau) if traffic.get("staleness_aware", True) \
                else alpha
            g = {a: {b: (1.0 - w) * g[a][b] + w * new[a][b] for b in sub}
                 for a, sub in g.items()}
            version += 1
            log["staleness"][c.tier].append(tau)
            log["update_counts"][c.tier] += 1
            log["eps_trajectory"][c.tier].append(p["eps"])
        before = total
        total += len(plans)
        if any(k % traffic["eval_every"] == 0
               for k in range(before + 1, total + 1)):
            log["times"].append(plans[-1][1]["t"])
            log["global_acc"].append(accuracy(g, pooled, groups, device))
            log["server_version"].append(version)
            for c in clients:
                log["local_acc"].setdefault(c.tier, []).append(
                    accuracy(g, c.test, groups, device))
        if total >= traffic["max_updates"]:
            break
        for c, p in plans:
            s = rng.integers(0, SEED_HIGH)
            plan = dispatch(c, s, g)
            heapq.heappush(heap, (p["t"] + plan["duration"], c.cid))
    return g, log, params0
