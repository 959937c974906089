"""The model zoo's serving path in PyTorch: configurations and parameter
initialisation (``common``), layer math (``layers``, ``ssm``), block and
stack assembly (``transformer``) and prefill / single-token decode
(``decode``). Ported families: dense GQA (yi-6b) and RWKV6 (rwkv6-3b)."""
