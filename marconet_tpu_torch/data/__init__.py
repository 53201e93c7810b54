"""Host-side training data: text-line synthesis (all but glyph
rendering), the degradation pipelines and training-batch preparation."""
