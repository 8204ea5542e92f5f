"""Training runtimes of the port (counterpart of `repro.runtime`): the online
trainer (`online`), the restart supervisor and offline trainer (`trainer`),
the stream guard (`guard`), RWKV6 serving (`serving`) and the multi-tenant
stream fleet (`fleet`: S online-RTRL sessions through one vmapped chunk,
`python -m repro_torch.launch.serve --fleet`)."""
