"""The benchmark of the port (vct_tpu_torch): one run of one cell is
`python3 -m vctbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`; BENCHMARK.json at the checkout's root names the cells."""
