"""REST API (aiohttp) and its auth primitives: the port of ``quiver_tpu/api``."""
