"""Device-side helpers shared by the batched pipelines (PCM wire codecs)."""
