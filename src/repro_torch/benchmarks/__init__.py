"""Benchmarks of the port: twins of the JAX package's ``benchmarks/``.

  bench_retrieval — the retrieval compression sweep, checked against the
                    committed ``BENCH_retrieval.json`` (read-only)
  common, bench_fig1_compression, bench_fig2_hashes, bench_fig3_time,
  bench_table3_alternatives, bench_table5_cbe, run
                  — the paper's own benches (Figs. 1-3, Tables 3 and 5)
  paper_phase     — the paper benches' checks: the Eq. 3 kernel route,
                    scores in range, the "learns" gate
"""
