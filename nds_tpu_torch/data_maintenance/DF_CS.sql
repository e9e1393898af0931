-- Copied from nds_tpu/data_maintenance/DF_CS.sql, unchanged.
-- DF_CS: delete catalog channel rows in the [DATE1, DATE2] sales-date window
-- (role of reference nds/data_maintenance/DF_CS.sql).
DELETE FROM catalog_returns WHERE cr_order_number IN
  (SELECT cs_order_number FROM catalog_sales WHERE cs_sold_date_sk IN
    (SELECT d_date_sk FROM date_dim
     WHERE d_date BETWEEN CAST('DATE1' AS DATE) AND CAST('DATE2' AS DATE)));
DELETE FROM catalog_sales WHERE cs_sold_date_sk IN
  (SELECT d_date_sk FROM date_dim
   WHERE d_date BETWEEN CAST('DATE1' AS DATE) AND CAST('DATE2' AS DATE))
