"""The paper's experiment harness on the port: one module per figure
(`fig3_schedules`, `fig4_devices`, `fig5_fedgan`, `fig6_scheduling`,
`fig_robust`) over the shared `common` harness, each run as
`python -m repro_torch.experiments.<name>`. Port of the JAX package's
`benchmarks/` figure scripts."""
