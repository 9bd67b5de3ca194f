"""The families of systems the benchmark drives: for each, the deployment
it draws, the program it serves it with, and the check of its answers."""
