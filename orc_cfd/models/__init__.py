from orc_cfd.models.channel_flow import (  # noqa: F401
    ChannelFlowParameters,
    analytical_stats,
    analytical_profile,
    couette_case,
    solve_channel_flow,
)
