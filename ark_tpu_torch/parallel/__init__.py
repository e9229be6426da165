"""Host-device pipelining of the port: `prefetch.PrefetchLoader`."""
