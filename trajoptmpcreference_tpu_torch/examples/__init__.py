"""The examples of the JAX package (examples/*.py), on the port.

Each is a module of this package, run as

    python -m trajoptmpcreference_tpu_torch.examples.<name> [--device cuda|cpu]
                                                            [--dtype float64|float32]

with the JAX script's own options and constants as defaults: twolinks,
threelinks, quadratic, compare_cost, pendulum, mpc_arm6, batch_sweep,
grid_sweep and display_final_traj, and ``helpers`` (runSQPExample,
runMPCExample).  ``--device`` (the card unless asked; it raises without
CUDA) and ``--dtype`` (float64 unless asked) take the place of the JAX
examples' EXAMPLES_TPU switch.  Each module exposes its configuration and
its run as functions, which the tests call at smaller sizes.
"""
