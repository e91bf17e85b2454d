"""One benchmark per paper table/figure (§7), on the port.

Each function sweeps K like the paper (``common.sweep_k``), reports the
optimum and the paper's qualitative claim, and prints a
``name,us_per_call,derived`` CSV line, as the JAX package's
``benchmarks/paper_tables.py`` does; ``us_per_call`` is the mean host
microseconds a round over the sweep's runs. Datasets: the synthetic
MNIST / Fashion proxies. Keyword arguments of each function go to
``sweep_k`` (``device``, ``jit``, and sizes such as ``n_clients``,
``samples``, ``t_sum``), so a small run fits the CPU; the client counts
and lazy fractions of Tables 4, 6 and 7 scale with ``n_clients``.

  PYTHONPATH=src python -m repro_torch.benchmarks.paper_tables   # the card
  PYTHONPATH=src python -m repro_torch.benchmarks.paper_tables --device cpu \\
      --clients 4 --samples 16 --t-sum 24 --only fig3_bound_gap
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import bounds
from repro_torch.core import dp as dp_lib


def _chain_valid(res: List[Dict]) -> bool:
    return all(r["chain_valid"] for r in res)


def _us(res: List[Dict]) -> float:
    return float(np.mean([r["us_per_round"] for r in res]))


def fig3_bound_gap(dataset="mnist", seed=0, **kw) -> Dict:
    """Fig. 3: developed upper bound vs experimental loss across K.
    Claims: bound >= experiment everywhere; both convex-ish; same argmin
    region; gap at the optimum small (paper: < 5%). ``sweep_s`` is the
    host clock around the sweep (the data build, every run and its final
    eval), ``rounds_s`` the runs' ``wall_s`` summed."""
    eta, alpha, beta, t_sum = 0.005, 1.0, 6.0, kw.pop("t_sum", 100.0)
    t0 = time.perf_counter()
    res = common.sweep_k(eta=eta, alpha=alpha, beta=beta, t_sum=t_sum,
                         dataset=dataset, seed=seed, **kw)
    sweep_s = time.perf_counter() - t0
    p = common.fit_bound_params(res, eta=eta, alpha=alpha, beta=beta,
                                t_sum=t_sum)
    rows = []
    for r in res:
        b = bounds.loss_bound(p, r["k"])
        rows.append({"k": r["k"], "empirical": r["final_loss"], "bound": b})
    finite = [r for r in rows if np.isfinite(r["bound"])]
    above = all(r["bound"] >= r["empirical"] - 1e-6 for r in finite)
    k_emp = min(rows, key=lambda r: r["empirical"])["k"]
    k_bnd = min(finite, key=lambda r: r["bound"])["k"]
    at_opt = next(r for r in finite if r["k"] == k_bnd)
    gap = abs(at_opt["bound"] - at_opt["empirical"]) / max(at_opt["empirical"], 1e-9)
    common.csv_line(f"fig3_bound_gap_{dataset}", _us(res),
                    f"gap_at_opt={gap:.3f};bound_above={above};"
                    f"k_emp={k_emp};k_bound={k_bnd}")
    return {"rows": rows, "gap": gap, "bound_above": above,
            "k_emp": k_emp, "k_bound": k_bnd, "chain_valid": _chain_valid(res),
            "driver": res[0]["driver"], "sweep_s": sweep_s,
            "rounds_s": float(sum(r["wall_s"] for r in res))}


def table2_alpha(dataset="mnist", seed=0, **kw) -> List[Dict]:
    """Table 2: training time per iteration alpha in {1,2,5}, beta=6.
    Claim (Cor. 1): optimal training time tau*alpha*K* grows with alpha;
    accuracy drops with alpha."""
    out = []
    for alpha in (1.0, 2.0, 5.0):
        res = common.sweep_k(alpha=alpha, beta=6.0, dataset=dataset,
                             seed=seed, **kw)
        best = common.best_of(res)
        out.append({"alpha": alpha, "k_star": best["k"],
                    "train_time": best["train_time"],
                    "accuracy": best["accuracy"],
                    "chain_valid": _chain_valid(res), "us": _us(res)})
    mono = all(a["train_time"] <= b["train_time"] for a, b in zip(out, out[1:]))
    acc_drop = out[0]["accuracy"] >= out[-1]["accuracy"]
    common.csv_line(f"table2_alpha_{dataset}",
                    float(np.mean([r["us"] for r in out])),
                    f"train_time={[r['train_time'] for r in out]};"
                    f"mono={mono};acc_drop={acc_drop}")
    return out


def table3_beta(dataset="mnist", seed=0, **kw) -> List[Dict]:
    """Table 3: mining time per block beta in {6,8,12}.
    Claim (Cor. 1): optimal mining time beta*K* grows with beta; accuracy
    drops with beta."""
    out = []
    for beta in (6.0, 8.0, 12.0):
        res = common.sweep_k(beta=beta, dataset=dataset, seed=seed, **kw)
        best = common.best_of(res)
        out.append({"beta": beta, "k_star": best["k"],
                    "mine_time": best["mine_time"],
                    "accuracy": best["accuracy"],
                    "chain_valid": _chain_valid(res), "us": _us(res)})
    mono = all(a["mine_time"] <= b["mine_time"] for a, b in zip(out, out[1:]))
    common.csv_line(f"table3_beta_{dataset}",
                    float(np.mean([r["us"] for r in out])),
                    f"mine_time={[r['mine_time'] for r in out]};mono={mono}")
    return out


def table4_clients(dataset="mnist", seed=0, **kw) -> List[Dict]:
    """Table 4: N in {10,15,20,25} (half to 1.25x of ``n_clients``, 20 by
    default), beta=6, 200 samples a client unless ``samples`` is given.
    Claims (Cor. 3): optimal mining time drops as N grows; loss drops with
    N; K* saturates for large N."""
    base = kw.pop("n_clients", 20)
    kw.setdefault("samples", 200)
    out = []
    for n in (round(base * f) for f in (0.5, 0.75, 1.0, 1.25)):
        res = common.sweep_k(n_clients=n, beta=6.0, dataset=dataset,
                             seed=seed, **kw)
        best = common.best_of(res)
        out.append({"n": n, "k_star": best["k"], "mine_time": best["mine_time"],
                    "final_loss": best["final_loss"],
                    "accuracy": best["accuracy"],
                    "chain_valid": _chain_valid(res), "us": _us(res)})
    k_sat = abs(out[-1]["k_star"] - out[-2]["k_star"]) <= 1
    common.csv_line(f"table4_clients_{dataset}",
                    float(np.mean([r["us"] for r in out])),
                    f"mine_time={[r['mine_time'] for r in out]};k_sat={k_sat}")
    return out


def table5_eta(dataset="mnist", seed=0, **kw) -> List[Dict]:
    """Table 5: eta in {0.005, 0.05, 0.1}.
    Claims (Cor. 4): optimal mining time beta*K* rises with eta (while
    eta*L<1); loss drops with eta until the bound regime breaks."""
    out = []
    for eta in (0.005, 0.05, 0.1):
        res = common.sweep_k(eta=eta, beta=6.0, dataset=dataset, seed=seed,
                             **kw)
        best = common.best_of(res)
        out.append({"eta": eta, "k_star": best["k"],
                    "mine_time": best["mine_time"],
                    "final_loss": best["final_loss"],
                    "accuracy": best["accuracy"],
                    "chain_valid": _chain_valid(res), "us": _us(res)})
    common.csv_line(f"table5_eta_{dataset}",
                    float(np.mean([r["us"] for r in out])),
                    f"mine_time={[r['mine_time'] for r in out]};"
                    f"loss={[round(r['final_loss'],3) for r in out]}")
    return out


def table6_lazy(dataset="mnist", seed=0, **kw) -> List[Dict]:
    """Table 6: lazy ratio M/N in {0,10%,20%,30%}, sigma2=0.01.
    Claims (Cor. 5): optimal training time tau*alpha*K* rises with M/N;
    performance degrades with M/N."""
    n = kw.get("n_clients", 20)
    out = []
    for frac in (0.0, 0.1, 0.2, 0.3):
        m = int(n * frac)
        res = common.sweep_k(n_lazy=m, sigma2=0.01, beta=6.0,
                             dataset=dataset, seed=seed, **kw)
        best = common.best_of(res)
        out.append({"lazy_frac": frac, "k_star": best["k"],
                    "train_time": best["train_time"],
                    "final_loss": best["final_loss"],
                    "accuracy": best["accuracy"],
                    "chain_valid": _chain_valid(res), "us": _us(res)})
    degraded = out[-1]["accuracy"] <= out[0]["accuracy"] + 0.02
    common.csv_line(f"table6_lazy_{dataset}",
                    float(np.mean([r["us"] for r in out])),
                    f"train_time={[r['train_time'] for r in out]};"
                    f"degraded={degraded}")
    return out


def table7_sigma(dataset="mnist", seed=0, **kw) -> List[Dict]:
    """Table 7: artificial-noise power sigma^2 in {0.01,0.1,0.2,0.3} at
    M/N=20%. Claims (Cor. 5): optimal training time grows with sigma^2;
    performance degrades as sigma^2 grows."""
    m = int(kw.get("n_clients", 20) * 0.2)
    out = []
    for s2 in (0.01, 0.1, 0.2, 0.3):
        res = common.sweep_k(n_lazy=m, sigma2=s2, beta=6.0, dataset=dataset,
                             seed=seed, **kw)
        best = common.best_of(res)
        out.append({"sigma2": s2, "k_star": best["k"],
                    "train_time": best["train_time"],
                    "final_loss": best["final_loss"],
                    "accuracy": best["accuracy"],
                    "chain_valid": _chain_valid(res), "us": _us(res)})
    degraded = out[-1]["accuracy"] <= out[0]["accuracy"] + 0.02
    common.csv_line(f"table7_sigma_{dataset}",
                    float(np.mean([r["us"] for r in out])),
                    f"train_time={[r['train_time'] for r in out]};"
                    f"degraded={degraded}")
    return out


def fig10_dp(dataset="mnist", seed=0, **kw) -> List[Dict]:
    """Figs 10-11: DP privacy budget eps sweep.
    Claims: accuracy rises with eps (weaker privacy); optimal K is NOT a
    function of eps (privacy and resource allocation decouple)."""
    out = []
    for eps in (2.0, 5.0, 10.0, 50.0):
        sigma = dp_lib.gaussian_sigma(eps, delta=1e-3, sensitivity=0.05)
        res = common.sweep_k(dp_sigma=sigma, beta=6.0, dataset=dataset,
                             seed=seed, **kw)
        best = common.best_of(res)
        out.append({"eps": eps, "dp_sigma": sigma, "k_star": best["k"],
                    "final_loss": best["final_loss"],
                    "accuracy": best["accuracy"],
                    "chain_valid": _chain_valid(res), "us": _us(res)})
    accs = [r["accuracy"] for r in out]
    k_spread = max(r["k_star"] for r in out) - min(r["k_star"] for r in out)
    common.csv_line(f"fig10_dp_{dataset}",
                    float(np.mean([r["us"] for r in out])),
                    f"acc={[round(a,3) for a in accs]};k_spread={k_spread}")
    return out


TABLES = {f.__name__: f for f in (fig3_bound_gap, table2_alpha, table3_beta,
                                  table4_clients, table5_eta, table6_lazy,
                                  table7_sigma, fig10_dp)}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--dataset", default="mnist", choices=["mnist", "fashion"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clients", type=int, default=None,
                    help="clients a run (default 20; Table 4 scales its "
                         "counts with it)")
    ap.add_argument("--samples", type=int, default=None,
                    help="samples a client (default 256; Table 4: 200)")
    ap.add_argument("--t-sum", type=float, default=None,
                    help="the time budget (default 100)")
    ap.add_argument("--only", nargs="+", choices=sorted(TABLES),
                    default=list(TABLES))
    a = ap.parse_args(argv)
    kw = {"device": a.device}
    for key, value in (("n_clients", a.clients), ("samples", a.samples),
                       ("t_sum", a.t_sum)):
        if value is not None:
            kw[key] = value
    out = {}
    for name in a.only:
        out[name] = TABLES[name](dataset=a.dataset, seed=a.seed, **dict(kw))
    rows = [out[n] for n in out if n != "fig3_bound_gap"]
    valid = all(r["chain_valid"] for table in rows for r in table) and (
        "fig3_bound_gap" not in out or out["fig3_bound_gap"]["chain_valid"])
    print(json.dumps({"chain_valid": valid, "tables": out}, default=float))
    return out


if __name__ == "__main__":
    main()
