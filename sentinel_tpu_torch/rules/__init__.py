"""rules (port of ``sentinel_tpu/rules``): the flow rule table, the
breaker table, the shaping and hot-parameter recurrences, and the flow,
degrade, system, authority and param-flow managers."""


def all_managers():
    """Every rule manager of the port."""
    from sentinel_tpu_torch.rules.authority_manager import authority_rule_manager
    from sentinel_tpu_torch.rules.degrade_manager import degrade_rule_manager
    from sentinel_tpu_torch.rules.flow_manager import flow_rule_manager
    from sentinel_tpu_torch.rules.param_manager import param_flow_rule_manager
    from sentinel_tpu_torch.rules.system_manager import system_rule_manager

    return [flow_rule_manager, degrade_rule_manager, system_rule_manager, authority_rule_manager,
            param_flow_rule_manager]
