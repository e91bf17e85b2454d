"""The paper's experiments and the round benchmark on the port, under the
JAX package's benchmark names (``benchmarks/`` at the root of the repo):
``common`` (the K sweep), ``paper_tables`` (Fig. 3, Tables 2-7, Fig. 10)
and ``bench_rounds`` (loop driver against graph driver)."""
