"""Deterministic fault injection (the counterpart of
``pyspark_tf_gke_tpu/chaos/``): named fault points and the injectors
(:mod:`~pyspark_tf_gke_tpu_torch.chaos.inject`). The chaos-schedule
spec, runner and invariant checker are not ported (ROADMAP queue 1);
the JAX package's checker reads this package's ``/traces`` as it reads
a JAX replica's."""

from pyspark_tf_gke_tpu_torch.chaos.inject import (  # noqa: F401
    FAULT_POINTS,
    ChaosInjector,
    FaultInjector,
    InjectedFault,
    chaos_fire,
    get_injector,
    install,
    split_serve_chaos_spec,
    uninstall,
)
