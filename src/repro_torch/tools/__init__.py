"""The serving soaks of the port (``python -m repro_torch.tools.<name>``).

Counterparts of the reference's ``tools/serve_soak.py``,
``tools/serve_chaos.py`` and ``tools/policy_smoke.py``, on one device:
the spill tier is pinned host memory on a card, the chaos plan's tier
loss is the ``host`` tier under ``kv_host``, and the policy smoke
replans ``kv=host:stream`` to ``hbm_resident``.
"""
