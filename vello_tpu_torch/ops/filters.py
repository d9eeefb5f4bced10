"""Layer filter kinds (copy of the constants of ``vello_tpu/ops/filters.py``
that ``scene.py`` encodes; the filters themselves come with the layered
compositor, ROADMAP item 10)."""

FILTER_NONE = 0
FILTER_BLUR = 1
FILTER_DROP_SHADOW = 2
FILTER_OFFSET = 3
FILTER_FLOOD = 4
