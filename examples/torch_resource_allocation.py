"""Resource allocation study (paper §4) on the PyTorch/CUDA port: sweep K,
compare the empirical loss with the Theorem 1 upper bound, and check the
Theorem 3 closed-form K*.

``examples/resource_allocation.py`` over the port's API
(``repro_torch.benchmarks.common``). On the GPU by default.

  PYTHONPATH=src python examples/torch_resource_allocation.py
  PYTHONPATH=src python examples/torch_resource_allocation.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.benchmarks import common
from repro_torch.core import allocation, bounds
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--samples", type=int, default=192,
                    help="samples a client")
    ap.add_argument("--t-sum", type=float, default=100.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    eta, alpha, beta, t_sum = 0.01, 1.0, 8.0, args.t_sum
    print(f"sweeping K (t_sum={t_sum}, alpha={alpha}, beta={beta}, eta={eta})")
    results = common.sweep_k(eta=eta, alpha=alpha, beta=beta, t_sum=t_sum,
                             n_clients=args.clients, samples=args.samples,
                             device=dev)
    p = common.fit_bound_params(results, eta=eta, alpha=alpha, beta=beta,
                                t_sum=t_sum)
    print(f"calibrated: L={p.L:.3f} xi={p.xi:.3f} delta={p.delta:.3f} "
          f"w0={p.w0_dist:.3f}")
    print(f"{'K':>3} {'tau':>4} {'train':>6} {'mine':>5} "
          f"{'loss':>8} {'bound':>8} {'acc':>6}")
    for r in results:
        b = bounds.loss_bound(p, r["k"])
        print(f"{r['k']:>3} {r['tau']:>4} {r['train_time']:>6.0f} "
              f"{r['mine_time']:>5.0f} {r['final_loss']:>8.4f} "
              f"{b:>8.4f} {r['accuracy']:>6.3f}")
    best = common.best_of(results)
    k_cf = bounds.k_star_closed_form(p)
    k_num = bounds.k_star_numeric(p)
    print(f"\nempirical K*={best['k']}  bound-argmin K*={k_num}  "
          f"closed-form (eq.6) K*={k_cf:.2f}")
    plan = allocation.plan(t_sum, best["k"], alpha, beta)
    print(f"optimal split: train {plan.train_time:.0f} / "
          f"mine {plan.mine_time:.0f} of {t_sum:.0f}")
    return {"results": results, "k_emp": best["k"], "k_bound": k_num,
            "k_closed_form": k_cf}


if __name__ == "__main__":
    main()
