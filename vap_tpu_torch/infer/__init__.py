"""Pipelines built from checkpoint directories (``infer/cog_vap.py`` and
``infer/wan_vap.py`` of the JAX package, their ``build_pipeline``)."""
