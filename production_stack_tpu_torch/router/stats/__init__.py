"""Router-side stats: engine /metrics scraping + request-level monitoring."""
