"""Feature apps layered over the broker core via hooks.

Parity: the reference's per-feature OTP applications (emqx_retainer,
emqx_modules' delayed/rewrite/topic_metrics/event_message, $SYS, the
tracer, the dashboard). Each app is a plain object constructed with the
`Node`, installing its hook callbacks in `load()` and removing them in
`unload()`: the hook registry is the only coupling. The port's copies of
their ``emqx_tpu/apps`` counterparts; ``boot.start_apps`` boots them from
the config as ``emqx_tpu/apps/boot.py`` does. They run on the host in
both packages: what reaches the card is the PUBLISH path they fold into.
"""
