"""rules (port of ``sentinel_tpu/rules``): the flow rule table and manager."""


def all_managers():
    """Every rule manager of the port (the flow manager, in this slice)."""
    from sentinel_tpu_torch.rules.flow_manager import flow_rule_manager

    return [flow_rule_manager]
