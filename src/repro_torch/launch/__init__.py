"""Command-line entry points (the port of ``repro.launch``): ``serve``,
batched greedy generation through the serving engine, and ``train``,
the fault-tolerant training loop on one device."""
