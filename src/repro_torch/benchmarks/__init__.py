"""The paper's experiments and the benchmarks on the port, under the JAX
package's benchmark names (``benchmarks/`` at the root of the repo):
``common`` (the K sweep), ``paper_tables`` (Fig. 3, Tables 2-7, Fig. 10),
``bench_rounds`` (loop driver against graph driver, and the kernel path),
the scenario benches ``bench_*``, ``roofline`` and ``gen_experiments``
(the dry-run's records as a table and as markdown), and ``run``, the
one-command harness over all of them."""
