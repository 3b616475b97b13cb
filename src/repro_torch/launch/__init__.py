"""Train and serve steps and the training entry point (``repro.launch``)."""
