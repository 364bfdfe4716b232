"""RELMAS multi-tenant scheduler in PyTorch, for one NVIDIA H100.

A second implementation of ``repro`` (the JAX package beside it), module
for module: ``costmodel`` and ``workloads`` build the tables,
``sim`` holds the arrival process, the contention engine and the
periodic environment, ``core`` the actor, heuristics and the serving
tick, ``serving`` the request queue and service, ``launch.serve`` the
driver; ``core.ddpg``/``replay``/``rollout``/``train``, ``ckpt`` and
``launch.rl_train`` DDPG training on one device or sharded over
several (one process a device); ``configs``,
``models`` and ``serving.batcher`` the LM data plane (every family),
``models.steps`` and ``launch.train`` LM training, ``models.sharding``
/ ``partition``, ``launch.mesh`` and ``runtime.elastic`` the LM on a
(data, model) mesh of DTensors.  Every kernel of those paths
(``kernels.*``) is a hand-written CUDA kernel whenever its tensors are
on the card.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
see :func:`repro_torch.device.resolve_device`.
"""
