"""ZeRO past stage 1: the stage-3 gather units, the host-offload tiers and
the zero.Init analogue."""
