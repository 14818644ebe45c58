"""Plan artifacts, target descriptors and the deployed ``CompiledNet`` —
counterparts of ``repro.compile``."""
