"""Adapters from a configuration and a traffic mix to the port's public
entry points; each module's ``build(config, traffic, device)`` returns an
:class:`vrbench.entries.common.Entry`."""
