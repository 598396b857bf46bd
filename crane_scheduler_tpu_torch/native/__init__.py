"""Host-side decoders of the port (``listdecode``: the LIST page decoder).

Counterpart of ``crane_scheduler_tpu/native/``. The port has only the
pure-Python twins so far; the bindings of the committed C++ library come
with ``ROADMAP.md`` Queue 1 item 8.4.
"""
