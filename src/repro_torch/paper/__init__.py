"""The paper's experiments on the port: Tables 4, 5, 6 and Figs. 7-8 and
13 (the port of ``benchmarks/{table4_energy,table5_datasets,
table6_comparison,fig7_8_variability,fig13_tuning_sweep}.py``).

    PYTHONPATH=src python -m repro_torch.paper [--only table4,fig13]
        [--device cpu]

Each module's ``main(*, device=None, ...)`` takes its sizes as keyword
arguments (the reference's values by default), prints the reference's
``name,us_per_call,derived`` rows and returns them (``common.Row``).
Everything runs on the card unless the caller passes ``device="cpu"``.
"""
