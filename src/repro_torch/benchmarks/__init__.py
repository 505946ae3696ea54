"""The SWIS paper's tables and figures on the port (port of the
reference's root ``benchmarks`` package, its paper tables only):
``common`` (timing, the trained benchmark model, the PTQ policies),
``paper_tables`` (one function per table or figure) and ``run`` (the CSV
driver: ``python -m repro_torch.benchmarks.run [filter] [--device cpu]``).

Import these modules by their full ``repro_torch.benchmarks.`` name: a bare
``benchmarks`` is the reference's package whenever the repository root is
on ``sys.path``."""
