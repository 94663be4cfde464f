"""Module injection: HF and Megatron checkpoints into the port's models
(``policies``), tensor-parallel layers (``layers``) and the policy-free
auto-TP walk (``auto_tp``). The policy names load on first use, so that
the models can import ``layers`` without a cycle."""

_POLICY_NAMES = ("HFGPT2Policy", "HFGPTNeoPolicy", "load_hf_model",
                 "policy_for")


def __getattr__(name):
    if name in _POLICY_NAMES:
        from . import policies
        return getattr(policies, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
