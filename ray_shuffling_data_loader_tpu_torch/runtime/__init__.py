"""Runtime health of the device binding (own copies of the JAX package's
``runtime/`` modules that ``device_dataset`` needs): the policy registry
(``policy``), the deadline watchdog (``watchdog``), the bounded retry
(``retry``) and seeded fault injection (``faults``)."""
