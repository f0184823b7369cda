"""Request router: the L5/L6 layer of the stack.

Async service that discovers serving-engine endpoints, scrapes their
stats, routes OpenAI-compatible requests with pluggable algorithms, and
proxies/streams responses. Counterpart of ``production_stack_tpu/router/``
file for file — the same HTTP surface, routing algorithms and Prometheus
metric names — on the standard library alone: HTTP on
``utils/web.py`` (server) and ``utils/http.py`` (client), metrics on
``utils/prometheus.py``, hashes on ``utils/xxh64.py``. It imports no
torch (a router pod has no card, and a router beside an engine must not
take a CUDA context), nor aiohttp, prometheus_client, yaml or xxhash,
which the machine with the card lacks.
"""
