"""Host pipeline of the port: AlignerEngine and streaming_align."""
