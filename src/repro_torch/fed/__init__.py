"""Federated-algorithm API: clock, population, registry and simulation
harness (port of ``repro.fed``).

One protocol (:class:`FedAlgorithm`: ``init / round / eval_params``), one
metrics schema (:data:`METRIC_KEYS`), one clock, one registry
(:func:`make_algorithm`), one population store with its participation
specs, one round engine (:class:`RoundEngine`: chunks of rounds, captured
as CUDA graphs on the card) and one harness (:func:`simulate` /
:func:`compare`) for every server variant:

    from repro_torch.fed import compare, make_algorithm
    algs = {n: make_algorithm(n, fed, loss_fn=..., template=...)
            for n in ("quafl", "fedavg")}
    traces = compare(algs, params0, data, generator, until_sim_time=1000.0,
                     eval_fn=lambda p: {"acc": ...})
"""
from repro_torch.fed.api import (FedAlgorithm, METRIC_KEYS,  # noqa: F401
                                 normalize_metrics)
from repro_torch.fed.clock import (ArrivalQueue,  # noqa: F401
                                   client_speeds, completion_time,
                                   completion_time_device, expected_steps,
                                   lazy_h_steps, sample_clients, speeds_for,
                                   straggler_round_time)
from repro_torch.fed.engine import (AUTOTUNE_CANDIDATES,  # noqa: F401
                                    DeviceFedAlgorithm, RingBuffer,
                                    RoundEngine, fedbuff_completion_table,
                                    fedbuff_event_seed, ring_init, ring_peek,
                                    ring_pop, ring_push, ring_size,
                                    supports_scan)
from repro_torch.fed.population import (  # noqa: F401
    CyclicParticipation, GammaStragglerParticipation, Participation,
    Population, SplitRow, UniformParticipation, build_population,
    client_keys, client_mesh, floyd_sample, gather_rows,
    lazy_h_steps_per_client, register_participation,
    registered_participations, resolve_participation, scatter_rows,
    shard_population, uniform_sample, whole_row, with_rows)
from repro_torch.fed.registry import (make_algorithm,  # noqa: F401
                                      register_algorithm,
                                      registered_algorithms)
from repro_torch.fed.simulate import Trace, compare, simulate  # noqa: F401
