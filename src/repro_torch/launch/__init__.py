"""launch substrate: step builders."""
