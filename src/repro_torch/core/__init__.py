"""DBB format, projection and packed parameter trees."""
