"""The benchmark's yardstick: frozen copies of the port's arithmetic and
constants, the deployment and traffic generators, the reduction of spans
and traces to metrics, and the comparison that decides ``correct``.

Nothing here imports the program (``repro_torch``), JAX or the JAX
package: a later change to the program cannot move what it is measured
against.
"""
