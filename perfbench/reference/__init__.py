"""The benchmark's plain reference: plain PyTorch, written from the
paper's and the models' equations, importing nothing of the program.

``mm``      the MM location estimate (weighted median, MAD, Tukey IRLS)
``lowp``    rounding to a lower precision, for the controls
``qwen3``   the Qwen3 decoder's forward and loss
``rwkv6``   the RWKV6 (Finch) forward and loss
``train``   the Mode A step: per-agent gradients, the additive attack,
            the per-leaf estimate, the global-norm clip and Adam
``serve``   one commit of the aggregation service: cohort weights,
            estimate, residual verdicts, trust clip, health and EMA
"""
