"""The model zoo's serving path in PyTorch: configurations and parameter
initialisation with each leaf's logical axes (``common``), layer math
(``layers``, ``ssm``), block and stack assembly (``transformer``) and
prefill / single-token decode (``decode``), the training losses
(``transformer``) and the activation layout constraints
(``pconstraint``). Ported
families: dense GQA (yi-6b, yi-34b, internlm2-1.8b, qwen3-14b), the
vision-language backbone (qwen2-vl-7b), dense/MoE pairs
(llama4-maverick-400b-a17b), the attention + Mamba hybrid (hymba-1.5b)
and RWKV6 (rwkv6-3b)."""
