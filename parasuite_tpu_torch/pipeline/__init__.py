"""Host pipeline of the port: AlignerEngine, CombinedEngine,
streaming_align and the two-pass API."""
